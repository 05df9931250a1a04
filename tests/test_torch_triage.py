"""The port's coverage and static-edge triage against the JAX
package's, bit for bit: the AFL map primitives, the dedup hash and
first-occurrence pass, throughput triage (rets, uc, uh and all three
virgin maps) and the exact sequential scan, on random counts with
slot collisions, crash/hang mixes, repeated lanes, and fresh and
partly-seen maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE
from killerbeez_tpu.instrumentation import jit_harness as jax_jh
from killerbeez_tpu.ops import coverage as jax_cov
from killerbeez_tpu.ops import sparse_coverage as jax_sparse
from killerbeez_tpu.ops import static_triage as jax_st
from killerbeez_tpu_torch.instrumentation import jit_harness
from killerbeez_tpu_torch.ops import coverage, sparse_coverage
from killerbeez_tpu_torch.ops import static_triage

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

MAP = 1 << 16


def _same(ref, out):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  out.numpy().astype(np.int64))


def test_classify_and_simplify_match():
    t = np.arange(256, dtype=np.uint8).repeat(3)
    _same(jax_cov.classify_counts(jnp.asarray(t)),
          coverage.classify_counts(torch.from_numpy(t)))
    _same(jax_cov.simplify_trace(jnp.asarray(t)),
          coverage.simplify_trace(torch.from_numpy(t)))


@pytest.mark.parametrize("case", ["fresh", "seen", "exact_repeat"])
def test_has_new_bits_matches(case):
    rng = np.random.default_rng(5)
    virgin = np.full(4096, 0xFF, np.uint8)
    trace = jax_cov.COUNT_CLASS_LOOKUP[rng.integers(0, 6, 4096)]
    trace[rng.random(4096) < 0.9] = 0
    if case == "seen":
        virgin = rng.integers(0, 256, 4096).astype(np.uint8)
    if case == "exact_repeat":
        virgin = virgin & ~trace
    r_ret, r_v = jax_cov.has_new_bits(jnp.asarray(virgin),
                                      jnp.asarray(trace))
    o_ret, o_v = coverage.has_new_bits(torch.from_numpy(virgin),
                                       torch.from_numpy(trace))
    assert int(r_ret) == int(o_ret)
    _same(r_v, o_v)


def test_stream_hash_and_first_occurrence_match():
    rng = np.random.default_rng(9)
    for t in (1, 2, 7, 64, 187):
        words = rng.integers(0, 2**32, (40, t), dtype=np.uint64)
        words[20:30] = words[0:10]
        _same(jax_sparse.stream_hash(jnp.asarray(words.astype(np.uint32))),
              sparse_coverage.stream_hash(
                  torch.from_numpy(words.astype(np.int64))))
    hashes = rng.integers(0, 6, 300).astype(np.uint32)
    crash = rng.random(300) < 0.3
    hang = rng.random(300) < 0.2
    ref = jax_sparse._first_occurrence_multi(
        jnp.asarray(hashes), jnp.asarray(crash), jnp.asarray(hang))
    out = sparse_coverage._first_occurrence_multi(
        torch.from_numpy(hashes.astype(np.int64)),
        torch.from_numpy(crash), torch.from_numpy(hang))
    for r, o in zip(ref, out):
        _same(r, o)


def _scenario(case, rng, B=96, E=60):
    """(edge_slot, counts, statuses, vb, vc, vh) for one scenario."""
    slot = rng.integers(0, 40, E).astype(np.int32)     # collisions
    slot[:3] = MAP - 1
    counts = rng.integers(0, 9, (B, E + 1)).astype(np.uint8)
    counts[rng.random((B, E + 1)) < 0.7] = 0
    counts[:, :4] = rng.integers(0, 255, (B, 4))
    r = B // 5
    counts[B // 2:B // 2 + r] = counts[:r]              # repeated lanes
    statuses = rng.choice([FUZZ_NONE, FUZZ_CRASH, FUZZ_HANG], B,
                          p=[0.5, 0.3, 0.2]).astype(np.int32)
    vb = np.full(MAP, 0xFF, np.uint8)
    vc = vb.copy()
    vh = vb.copy()
    if case == "seen":
        u = np.unique(slot)
        vb[u] = rng.integers(0, 256, len(u))
        vc[u] = rng.integers(0, 256, len(u))
        vc[rng.integers(0, MAP, 500)] = 0xFE
        vh = vh & 0xFE                       # a hang was seen before
    elif case == "no_crash":
        statuses[statuses == FUZZ_CRASH] = FUZZ_NONE
    elif case == "all_same":
        counts[:] = counts[0]
    return slot, counts, statuses, vb, vc, vh


CASES = ["fresh", "seen", "no_crash", "all_same"]


@pytest.mark.parametrize("case", CASES)
def test_static_triage_matches(case):
    rng = np.random.default_rng(CASES.index(case))
    slot, counts, statuses, vb, vc, vh = _scenario(case, rng)
    us, seg = jax_st.make_static_maps(slot)
    crash, hang = statuses == FUZZ_CRASH, statuses == FUZZ_HANG
    ref = jax.jit(jax_st.static_triage)(*map(jnp.asarray, (vb, vc, vh, counts, us,
                                                  seg, crash, hang)))
    out = static_triage.static_triage(
        *map(torch.from_numpy, (vb, vc, vh, counts, us, seg, crash,
                                hang)))
    for r, o in zip(ref, out):
        _same(r, o)
    by_slot = static_triage.counts_by_slot(torch.from_numpy(counts),
                                           torch.from_numpy(seg), len(us))
    _same(jax_st.expand_to_map(jax_st.counts_by_slot(
              jnp.asarray(counts), jnp.asarray(seg), len(us)),
              jnp.asarray(us)),
          static_triage.expand_to_map(by_slot, torch.from_numpy(us)))


@pytest.mark.parametrize("case", CASES)
def test_exact_triage_matches_sequential_scan(case):
    """The port's vectorized exact triage against the JAX package's
    sequential scan over the dense maps (_triage_counts exact=True)."""
    rng = np.random.default_rng(10 + CASES.index(case))
    slot, counts, statuses, vb, vc, vh = _scenario(case, rng, B=48)
    us, seg = jax_st.make_static_maps(slot)
    ref = jax.jit(jax_jh._triage_counts, static_argnums=7)(
        jnp.asarray(counts), jnp.asarray(statuses), jnp.asarray(us),
        jnp.asarray(seg), jnp.asarray(vb), jnp.asarray(vc),
        jnp.asarray(vh), True)
    out = jit_harness._triage_counts(
        torch.from_numpy(counts), torch.from_numpy(statuses),
        torch.from_numpy(us), torch.from_numpy(seg),
        torch.from_numpy(vb), torch.from_numpy(vc), torch.from_numpy(vh),
        True)
    for r, o in zip(ref, out):
        _same(r, o)
