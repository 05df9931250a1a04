"""The port's mutation core (ops/mutate_core.py) and the jax.random
draws it makes (ops/prng.py) against the JAX package, bit for bit:
split, randint, uniform and bernoulli; the block helpers; every
deterministic walk over its whole length (and past its end) for every
live length up to L; and the keyed edits (zzuf, splice, the honggfuzz
mangle).  Integer and bit semantics: no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.ops import mutate_core as J
from killerbeez_tpu_torch.ops import mutate_core as T
from killerbeez_tpu_torch.ops import prng

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

L = 16


def _keys(seed, its):
    """The same per-lane keys in both packages: fold_in(key(seed), it)."""
    its = np.asarray(its, dtype=np.uint32)
    base = jax.random.key(seed)
    jk = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(its))
    tk = prng.fold_in(prng.key(seed), torch.from_numpy(its.astype(np.int64)))
    return jk, tk


def _eq(ref, out):
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


# -- jax.random ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 6])
def test_split_matches_jax(n):
    jk, tk = _keys(9, range(40))
    ref = jax.vmap(lambda k: jax.random.key_data(jax.random.split(k, n)))(jk)
    np.testing.assert_array_equal(np.asarray(ref), prng.split(tk, n).numpy())


@pytest.mark.parametrize("lo,hi", [
    (0, 6), (0, 8), (1, 2), (0, 256), (1, 256), (0, 65536), (3, 70001),
    (0, 2**31 - 1), (-50, 50), (5, 5), (9, 2), (1, 1 << 20),
])
def test_randint_matches_jax(lo, hi):
    jk, tk = _keys(4, range(300))
    ref = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(jk)
    np.testing.assert_array_equal(np.asarray(ref),
                                  prng.randint(tk, lo, hi).numpy())


def test_randint_per_lane_bounds_match_jax():
    """Bounds that are tensors, one per lane: spans of every size up to
    100, some empty (maxval <= minval returns minval)."""
    rng = np.random.default_rng(2)
    lo = rng.integers(-20, 50, 300).astype(np.int32)
    hi = rng.integers(-20, 100, 300).astype(np.int32)
    jk, tk = _keys(5, range(300))
    ref = jax.vmap(jax.random.randint, in_axes=(0, None, 0, 0))(
        jk, (), jnp.asarray(lo), jnp.asarray(hi))
    out = prng.randint(tk, torch.from_numpy(lo.astype(np.int64)),
                       torch.from_numpy(hi.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    # the uint8 cast the mutators apply after randint(0, 256)
    ref8 = jax.vmap(lambda k: jax.random.randint(k, (), 0, 256).astype(
        jnp.uint8))(jk)
    np.testing.assert_array_equal(
        np.asarray(ref8), prng.randint(tk, 0, 256).to(torch.uint8).numpy())


@pytest.mark.parametrize("p", [0.004, 0.5, 1.0])
def test_uniform_and_bernoulli_match_jax(p):
    jk, tk = _keys(6, range(64))
    u = jax.vmap(lambda k: jax.random.uniform(k, (L, 8)))(jk)
    np.testing.assert_array_equal(
        np.asarray(u).reshape(64, -1), prng.uniform(tk, L * 8).numpy())
    b = jax.vmap(lambda k: jax.random.bernoulli(k, p, (L, 8)))(jk)
    np.testing.assert_array_equal(np.asarray(b).reshape(64, -1),
                                  prng.bernoulli(tk, p, L * 8).numpy())
    b0 = jax.vmap(lambda k: jax.random.bernoulli(k, p))(jk)
    np.testing.assert_array_equal(np.asarray(b0),
                                  prng.bernoulli(tk, p, 1)[:, 0].numpy())


def test_fold_in_of_a_python_int_into_many_keys():
    jk, tk = _keys(8, range(20))
    ref = jax.vmap(lambda k: jax.random.key_data(
        jax.random.fold_in(k, jnp.uint32(7))))(jk)
    np.testing.assert_array_equal(np.asarray(ref), prng.fold_in(tk, 7).numpy())


# -- the block helpers --------------------------------------------------

def _rand_batch(seed, B=200):
    rng = np.random.default_rng(seed)
    bufs = rng.integers(0, 256, (B, L)).astype(np.uint8)
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    a = rng.integers(-3, L + 3, B).astype(np.int32)
    b = rng.integers(-3, L + 3, B).astype(np.int32)
    c = rng.integers(0, L + 2, B).astype(np.int32)
    vals = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    flags = rng.integers(0, 2, B).astype(bool)
    t = [torch.from_numpy(x.astype(np.int64)) if x.dtype != np.uint8
         and x.dtype != bool else torch.from_numpy(x)
         for x in (bufs, lens, a, b, c, vals, flags)]
    return (bufs, lens, a, b, c, vals, flags), t


@pytest.mark.parametrize("nb", [1, 2, 4, 8, 16, 32])
def test_flip_bits_matches_jax(nb):
    (bufs, _, a, *_), (tb, _, ta, *_) = _rand_batch(nb)
    start = a * 8 + (a % 8)
    ref = jax.vmap(J.flip_bits, in_axes=(0, 0, None))(
        jnp.asarray(bufs), jnp.asarray(start), nb)
    np.testing.assert_array_equal(
        np.asarray(ref),
        T.flip_bits(tb, torch.from_numpy(start.astype(np.int64)), nb).numpy())


@pytest.mark.parametrize("width", [1, 2, 4])
def test_read_and_write_bytes_match_jax(width):
    (bufs, _, a, _, _, vals, flags), (tb, _, ta, _, _, tv, tf) = \
        _rand_batch(10 + width)
    ref_r = jax.vmap(J.read_bytes, in_axes=(0, 0, None, 0))(
        jnp.asarray(bufs), jnp.asarray(a), width, jnp.asarray(flags))
    np.testing.assert_array_equal(np.asarray(ref_r).astype(np.int64),
                                  T.read_bytes(tb, ta, width, tf).numpy())
    ref_w = jax.vmap(J.write_bytes, in_axes=(0, 0, 0, None, 0))(
        jnp.asarray(bufs), jnp.asarray(a), jnp.asarray(vals), width,
        jnp.asarray(flags))
    np.testing.assert_array_equal(
        np.asarray(ref_w), T.write_bytes(tb, ta, tv, width, tf).numpy())


def test_block_helpers_match_jax():
    (bufs, lens, a, b, c, vals, flags), (tb, tl, ta, tb2, tc, tv, tf) = \
        _rand_batch(21)
    pos = np.clip(a, 0, L - 1)
    tpos = torch.from_numpy(pos.astype(np.int64))
    fill = (vals & 0xFF).astype(np.uint8)
    tfill = torch.from_numpy(fill)
    ref = jax.vmap(J.delete_block)(jnp.asarray(bufs), jnp.asarray(lens),
                                   jnp.asarray(pos), jnp.asarray(c))
    _eq(ref, T.delete_block(tb, tl, tpos, tc))
    ref = jax.vmap(J.insert_block)(
        jnp.asarray(bufs), jnp.asarray(lens), jnp.asarray(pos),
        jnp.asarray(c), jnp.asarray(b), jnp.asarray(fill),
        jnp.asarray(flags))
    _eq(ref, T.insert_block(tb, tl, tpos, tc, tb2, tfill, tf))
    ref = jax.vmap(J.overwrite_block)(
        jnp.asarray(bufs), jnp.asarray(pos), jnp.asarray(c),
        jnp.asarray(b), jnp.asarray(fill), jnp.asarray(flags))
    np.testing.assert_array_equal(
        np.asarray(ref),
        T.overwrite_block(tb, tpos, tc, tb2, tfill, tf).numpy())


# -- the deterministic walks --------------------------------------------

_SEED = np.random.default_rng(31).integers(0, 256, L).astype(np.uint8)

_J_FLIP = {nb: jax.jit(jax.vmap(
    lambda b, ln, it, nb=nb: J.bit_flip_at(b, ln, it, num_bits=nb),
    in_axes=(None, None, 0))) for nb in (1, 2, 4, 8, 16, 32)}
_J_ARITH = jax.jit(jax.vmap(J.arithmetic_at, in_axes=(None, None, 0)))
_J_INT = jax.jit(jax.vmap(J.interesting_at, in_axes=(None, None, 0)))
_J_DICT = jax.jit(jax.vmap(J.dictionary_at,
                           in_axes=(None, None, 0, None, None)))


def _walk(ref_fn, port_fn, total_fn, *extra_j, extra_t=()):
    """Every live length 1..L, iterations over the whole walk of the
    longest one (past the end of the shorter ones')."""
    its = np.arange(total_fn(L) + 7)
    for n in range(1, L + 1):
        ref = ref_fn(jnp.asarray(_SEED), jnp.int32(n),
                     jnp.asarray(its, jnp.int32), *extra_j)
        out = port_fn(torch.from_numpy(_SEED), n, torch.from_numpy(its),
                      *extra_t)
        _eq(ref, out)


@pytest.mark.parametrize("nb", [1, 2, 4, 8, 16, 32])
def test_bit_flip_walk_matches_jax(nb):
    for n in range(L + 1):
        assert T.bit_flip_total(n, nb) == J.bit_flip_total(n, nb)
    _walk(_J_FLIP[nb], lambda b, n, it: T.bit_flip_at(b, n, it, nb),
          lambda n: T.bit_flip_total(n, nb))


def test_arithmetic_walk_matches_jax():
    for n in range(L + 1):
        assert T.arithmetic_total(n) == J.arithmetic_total(n)
    _walk(_J_ARITH, T.arithmetic_at, T.arithmetic_total)


def test_interesting_walk_matches_jax():
    for n in range(L + 1):
        assert T.interesting_total(n) == J.interesting_total(n)
    _walk(_J_INT, T.interesting_at, T.interesting_total)


@pytest.mark.parametrize("toks", [
    [b"STK1", b"\x01", b"ABCDEFGHIJKLMNOPQRS"[:L], b"zz"],
    [b"\xff"],
])
def test_dictionary_walk_matches_jax(toks):
    tl = max(len(t) for t in toks)
    arr = np.zeros((len(toks), tl), np.uint8)
    for i, t in enumerate(toks):
        arr[i, :len(t)] = np.frombuffer(t, np.uint8)
    lens = np.array([len(t) for t in toks], np.int32)
    for n in range(L + 1):
        assert T.dictionary_total(n, len(toks)) == \
            J.dictionary_total(n, len(toks))
    _walk(_J_DICT, T.dictionary_at,
          lambda n: T.dictionary_total(n, len(toks)),
          jnp.asarray(arr), jnp.asarray(lens),
          extra_t=(torch.from_numpy(arr), torch.from_numpy(lens)))


def test_walk_iterations_are_int32():
    """JAX decodes walk iterations as int32: a number past 2**31 wraps
    to a negative iteration, which both packages map the same way."""
    its = np.array([2**31 + 5, 2**32 - 1, 2**32 + 3], dtype=np.int64)
    ref = _J_FLIP[1](jnp.asarray(_SEED), jnp.int32(L),
                     jnp.asarray(its.astype(np.int32)))
    _eq(ref, T.bit_flip_at(torch.from_numpy(_SEED), L,
                           torch.from_numpy(its), 1))
    ref = _J_ARITH(jnp.asarray(_SEED), jnp.int32(L),
                   jnp.asarray(its.astype(np.int32)))
    _eq(ref, T.arithmetic_at(torch.from_numpy(_SEED), L,
                             torch.from_numpy(its)))


# -- the keyed edits ----------------------------------------------------

@pytest.mark.parametrize("ratio", [0.004, 0.05, 0.5, 1.0])
def test_zzuf_matches_jax(ratio):
    jk, tk = _keys(12, range(1000, 1300))
    fn = jax.vmap(lambda b, ln, k: J.zzuf_at(b, ln, k, ratio=ratio),
                  in_axes=(None, None, 0))
    for n in (1, 5, L):
        _eq(fn(jnp.asarray(_SEED), jnp.int32(n), jk),
            T.zzuf_at(torch.from_numpy(_SEED), n, tk, ratio))


def test_splice_matches_jax():
    rng = np.random.default_rng(13)
    pb = rng.integers(0, 256, (300, L)).astype(np.uint8)
    pl = rng.integers(1, L + 1, 300).astype(np.int32)
    jk, tk = _keys(13, range(300))
    fn = jax.vmap(J.splice_at, in_axes=(None, None, 0, 0, 0))
    for n in (1, 2, 9, L):
        _eq(fn(jnp.asarray(_SEED), jnp.int32(n), jnp.asarray(pb),
               jnp.asarray(pl), jk),
            T.splice_at(torch.from_numpy(_SEED), n, torch.from_numpy(pb),
                        torch.from_numpy(pl), tk))


@pytest.mark.parametrize("max_ops", [1, 8, 17])
def test_mangle_matches_jax(max_ops):
    seed = _SEED.copy()
    seed[3:9] = np.frombuffer(b"012389", np.uint8)   # digits to corrupt
    jk, tk = _keys(14 + max_ops, range(400))
    fn = jax.vmap(lambda b, ln, k: J.mangle_at(b, ln, k, max_ops=max_ops),
                  in_axes=(None, None, 0))
    for n in (1, 4, 11, L):
        _eq(fn(jnp.asarray(seed), jnp.int32(n), jk),
            T.mangle_at(torch.from_numpy(seed), n, tk, max_ops))


def test_mangle_one_matches_jax():
    rng = np.random.default_rng(15)
    bufs = rng.integers(40, 70, (500, L)).astype(np.uint8)  # some digits
    lens = rng.integers(1, L + 1, 500).astype(np.int32)
    jk, tk = _keys(15, range(500))
    ref = jax.vmap(J._mangle_one)(jnp.asarray(bufs), jnp.asarray(lens), jk)
    out_b, out_l = T._mangle_one(torch.from_numpy(bufs),
                                 torch.from_numpy(lens.astype(np.int64)), tk)
    np.testing.assert_array_equal(np.asarray(ref[0]), out_b.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), out_l.numpy())
