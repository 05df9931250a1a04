"""The port's dense and sparse coverage ops against the JAX package's,
bit for bit: ``has_new_bits_with_ignore``, ``update_virgin``,
``has_new_bits_seq``, ``has_new_bits_batch``, ``build_bitmap``,
``count_bytes`` (ops/coverage.py) and ``first_occurrence``,
``sparse_classify``, ``sparse_has_new_bits_batch``,
``_virgin_update_mask``, ``_novelty_rets``, ``_presence_mask``,
``sparse_triage``, ``sparse_simplify`` (ops/sparse_coverage.py), on
streams with in-batch duplicates, inactive lanes, negative and
>= MAP_SIZE ids, and edges hit 256 times or more (counts wrap).
Tolerance: none (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu import MAP_SIZE
from killerbeez_tpu.ops import coverage as jcov
from killerbeez_tpu.ops import sparse_coverage as jsp
from killerbeez_tpu_torch.ops import coverage as cov
from killerbeez_tpu_torch.ops import sparse_coverage as sp

torch.set_num_threads(1)

B, T = 24, 300


def _eq(ref, got, what=""):
    np.testing.assert_array_equal(
        np.asarray(ref).astype(np.int64),
        np.asarray(got).astype(np.int64), err_msg=what)


def _streams(seed):
    """int32[B, T] edge streams and bool[B, T] validity: ids mostly in a
    small window (shared edges, repeats), some negative, some at or past
    MAP_SIZE; lane 0 hits one edge 300 times (count 300 wraps to 44),
    lanes 5 and 6 repeat lanes 3 and 4 (in-batch duplicates)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 40, (B, T)).astype(np.int32)
    ids[rng.random((B, T)) < 0.05] = -1
    far = rng.random((B, T)) < 0.03
    ids[far] = rng.integers(-MAP_SIZE - 5, 2 * MAP_SIZE, far.sum())
    ids[:, :3] = MAP_SIZE - 1 - rng.integers(0, 3, (B, 3))
    ids[0] = 7
    ids[5], ids[6] = ids[3], ids[4]
    steps = rng.integers(0, T + 1, B)
    steps[0] = T
    steps[5], steps[6] = steps[3], steps[4]
    valid = np.arange(T)[None, :] < steps[:, None]
    return ids, valid


def _virgin(seed):
    rng = np.random.default_rng(seed)
    v = np.full(MAP_SIZE, 0xFF, np.uint8)
    hit = rng.integers(0, 40, 25)
    v[hit] = rng.integers(0, 256, 25).astype(np.uint8)
    v[MAP_SIZE - 2] = 0x7F
    return v


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_build_bitmap_and_count_bytes(seed):
    ids, valid = _streams(seed)
    ref = np.asarray(jcov.build_bitmap(jnp.asarray(ids),
                                       jnp.asarray(valid)))
    got = cov.build_bitmap(torch.from_numpy(ids), torch.from_numpy(valid))
    _eq(ref, got.numpy())
    assert got.dtype == torch.uint8 and int(got[0, 7]) == 300 % 256
    for row in range(3):
        assert int(cov.count_bytes(got[row])) == \
            int(jcov.count_bytes(jnp.asarray(ref[row])))
    small = np.asarray(jcov.build_bitmap(jnp.asarray(ids),
                                         jnp.asarray(valid), map_size=64))
    _eq(small, cov.build_bitmap(torch.from_numpy(ids),
                                torch.from_numpy(valid), map_size=64))


@pytest.mark.parametrize("seed", [4, 5])
def test_dense_novelty_matches_jax(seed):
    ids, valid = _streams(seed)
    bitmaps = np.asarray(jcov.build_bitmap(jnp.asarray(ids),
                                           jnp.asarray(valid)))
    traces = np.array(jcov.classify_counts(jnp.asarray(bitmaps)))
    virgin = _virgin(seed)
    tv, tt = torch.from_numpy(virgin), torch.from_numpy(traces)

    rets, v2 = jcov.has_new_bits_seq(jnp.asarray(virgin),
                                     jnp.asarray(traces))
    grets, gv2 = cov.has_new_bits_seq(tv, tt)
    _eq(rets, grets)
    _eq(v2, gv2)

    ignore = (np.random.default_rng(seed).random(MAP_SIZE) < 0.5) \
        .astype(np.uint8)
    for row in range(4):
        r, v = jcov.has_new_bits_with_ignore(
            jnp.asarray(virgin), jnp.asarray(traces[row]),
            jnp.asarray(ignore))
        gr, gv = cov.has_new_bits_with_ignore(tv, tt[row],
                                              torch.from_numpy(ignore))
        assert int(r) == int(gr)
        _eq(v, gv)
        _eq(jcov.update_virgin(jnp.asarray(virgin),
                               jnp.asarray(traces[row])),
            cov.update_virgin(tv, tt[row]))

    hashes = np.random.default_rng(seed).integers(
        0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32)
    hashes[5], hashes[6] = hashes[3], hashes[4]   # in-batch duplicates
    hashes[9] = hashes[2]
    hashes[1] |= 0x80000000
    th = torch.from_numpy(hashes.astype(np.int64))
    active = np.ones(B, bool)
    active[[2, 4, 11]] = False                    # inactive lanes
    for act in (None, active):
        r, v = jcov.has_new_bits_batch(
            jnp.asarray(virgin), jnp.asarray(traces), jnp.asarray(hashes),
            None if act is None else jnp.asarray(act))
        gr, gv = cov.has_new_bits_batch(
            tv, tt, th, None if act is None else torch.from_numpy(act))
        _eq(r, gr)
        _eq(v, gv)


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_sparse_ops_match_jax(seed):
    ids, valid = _streams(seed)
    jids, jvalid = jnp.asarray(ids), jnp.asarray(valid)
    tids, tvalid = torch.from_numpy(ids), torch.from_numpy(valid)
    rids, rcls = jsp.sparse_classify(jids, jvalid)
    gids, gcls = sp.sparse_classify(tids, tvalid)
    _eq(rids, gids, "ids")
    _eq(rcls, gcls, "cls")
    assert gids.dtype == torch.int32 and gcls.dtype == torch.uint8
    # negative ids that are marked valid stay live, as in the reference
    raw = jsp.sparse_classify(jids, jnp.ones_like(jvalid))
    got = sp.sparse_classify(tids, torch.ones_like(tvalid))
    _eq(raw[0], got[0])
    _eq(raw[1], got[1])
    _eq(jsp.sparse_simplify(rids), sp.sparse_simplify(gids))

    virgin = _virgin(seed)
    tv = torch.from_numpy(virgin)
    for rid, rc, gid, gc in ((rids, rcls, gids, gcls),
                             (raw[0], raw[1], got[0], got[1])):
        _eq(jsp._novelty_rets(jnp.asarray(virgin), rid, rc),
            sp._novelty_rets(tv, gid, gc))
        is_new = np.random.default_rng(seed).random(B) < 0.6
        _eq(jsp._virgin_update_mask(rid, rc, jnp.asarray(is_new)),
            sp._virgin_update_mask(gid, gc, torch.from_numpy(is_new)))
        _eq(jsp._presence_mask(rid, jnp.asarray(is_new)),
            sp._presence_mask(gid, torch.from_numpy(is_new)))

    active = np.ones(B, bool)
    active[[1, 3, 8]] = False
    for act in (None, active):
        r, v = jsp.sparse_has_new_bits_batch(
            jnp.asarray(virgin), rids, rcls,
            None if act is None else jnp.asarray(act))
        gr, gv = sp.sparse_has_new_bits_batch(
            tv, gids, gcls, None if act is None else torch.from_numpy(act))
        _eq(r, gr)
        _eq(v, gv)

    rng = np.random.default_rng(seed)
    crash = rng.random(B) < 0.3
    hang = ~crash & (rng.random(B) < 0.3)
    vc = _virgin(seed + 100)
    vh = _virgin(seed + 200)
    ref = jsp.sparse_triage(jnp.asarray(virgin), jnp.asarray(vc),
                            jnp.asarray(vh), jids, jvalid,
                            jnp.asarray(crash), jnp.asarray(hang))
    out = sp.sparse_triage(tv, torch.from_numpy(vc), torch.from_numpy(vh),
                           tids, tvalid, torch.from_numpy(crash),
                           torch.from_numpy(hang))
    for i, (a, b) in enumerate(zip(ref, out)):
        _eq(a, b, f"sparse_triage output {i}")


@pytest.mark.parametrize("seed", [9, 10])
def test_first_occurrence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, 6, 64).astype(np.uint32)
    hashes[::7] |= 0x80000000
    active = rng.random(64) < 0.7
    ref = jsp.first_occurrence(jnp.asarray(hashes), jnp.asarray(active))
    got = sp.first_occurrence(torch.from_numpy(hashes.astype(np.int64)),
                              torch.from_numpy(active))
    _eq(ref, got)
