"""Focused mutation in the port against the JAX package, bit for bit:
``havoc_focus_at`` and ``zzuf_focus_at`` (every stack depth, masks with
positions past the live length, padded masks), the focused ``havoc``,
``zzuf`` and ``afl`` (havoc tail) mutators batch by batch with a mask
installed, swapped and cleared, and the stand-down of the fused path:
with a mask installed the ``cuda_fused`` engine runs the masked
candidates through the unfused path (on the CPU the plain engine; the
card's ``kbz_vm_kernel_all`` launches are held in
``tests/test_torch_kernels_cuda.py``), and fusion resumes once the mask
clears.  Tolerance: none."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.mutators.factory import mutator_factory as jax_factory
from killerbeez_tpu.ops import mutate_core as J
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.instrumentation.factory import (
    instrumentation_factory,
)
from killerbeez_tpu_torch.mutators.factory import mutator_factory
from killerbeez_tpu_torch.ops import mutate_core as T
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.ops.vm_kernel import havoc_words_for_keys

torch.set_num_threads(1)

L = 16
_SEED = np.frombuffer(b"\x00\x10 0@P`p\x80\x90\xa0\xb0\xc0\xd0\xe0\xf0",
                      np.uint8).copy()
MASKS = [[0], [3, 7], [1, 2, 5, 11], [15, 15, 3, 3]]


def _keys(seed, its):
    its = np.asarray(its, dtype=np.uint32)
    base = jax.random.key(seed)
    jk = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(its))
    tk = prng.fold_in(prng.key(seed), torch.from_numpy(its.astype(np.int64)))
    return jk, tk


def _eq(ref, out):
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


@pytest.mark.parametrize("sp", [1, 4, 7])
@pytest.mark.parametrize("mask", MASKS, ids=[str(m) for m in MASKS])
def test_havoc_focus_matches_jax(mask, sp):
    """Every edit anchored on the mask (clamped to the live length, so
    positions past a short seed land on its last byte)."""
    jk, tk = _keys(21, range(300, 300 + 160))
    pos = np.asarray(mask, np.int32)
    fn = jax.vmap(lambda b, ln, k, p: J.havoc_focus_at(b, ln, k, p,
                                                       stack_pow2=sp),
                  in_axes=(None, None, 0, None))
    words = havoc_words_for_keys(tk, sp)
    for n in (1, 6, L):
        _eq(fn(jnp.asarray(_SEED), jnp.int32(n), jk, jnp.asarray(pos)),
            T.havoc_focus_at(torch.from_numpy(_SEED), n, words,
                             torch.from_numpy(pos), sp))


def test_havoc_focus_concentrates_edits_on_the_mask():
    """The mask changes the candidates (same words, other positions),
    and among full-length lanes the masked byte is the one edited most
    often."""
    _, tk = _keys(5, range(2000))
    words = havoc_words_for_keys(tk, 1)
    seed = torch.from_numpy(_SEED)
    fb, fl = T.havoc_focus_at(seed, L, words, torch.tensor([9]), 1)
    ub, _ = T.havoc_at(seed, L, words, 1)
    assert not torch.equal(fb, ub)
    freq = (fb[fl == L] != seed[None, :]).float().mean(dim=0)
    assert int(freq.argmax()) == 9


@pytest.mark.parametrize("ratio", [0.004, 0.5])
@pytest.mark.parametrize("mask", MASKS, ids=[str(m) for m in MASKS])
def test_zzuf_focus_matches_jax(mask, ratio):
    """The ratio rescaled by L / |mask| in float32, flips kept only on
    mask bytes."""
    jk, tk = _keys(12, range(1000, 1200))
    pos = np.asarray(mask, np.int32)
    fn = jax.vmap(lambda b, ln, k, p: J.zzuf_focus_at(b, ln, k, p,
                                                      ratio=ratio),
                  in_axes=(None, None, 0, None))
    for n in (1, 5, L):
        ref = fn(jnp.asarray(_SEED), jnp.int32(n), jk, jnp.asarray(pos))
        out = T.zzuf_focus_at(torch.from_numpy(_SEED), n, tk,
                              torch.from_numpy(pos), ratio)
        _eq(ref, out)
        changed = (out[0].numpy() != _SEED[None, :]).any(axis=0)
        assert set(np.flatnonzero(changed)) <= set(mask)


FOCUSED = [
    ("havoc", {"seed": 3}),
    ("havoc", {"seed": 3, "stack_pow2": 2}),
    ("zzuf", {"seed": 4}),
    ("zzuf", {"seed": 4, "ratio_bits": 0.05}),
    ("afl", {"seed": 8, "skip_deterministic": 1}),
    ("afl", {"seed": 8}),
]
SEED = b"STK1\x01\x0542"


def _pair(name, opts):
    o = json.dumps(opts)
    return (jax_factory(name, o, SEED),
            mutator_factory(name, o, SEED, device="cpu"))


def _batches_equal(ref, port, sizes):
    for n in sizes:
        rb, rl = ref.mutate_batch(n)
        pb, pl = port.mutate_batch(n)
        np.testing.assert_array_equal(np.asarray(rb), pb.numpy())
        np.testing.assert_array_equal(np.asarray(rl), pl.numpy())


@pytest.mark.parametrize("name,opts", FOCUSED,
                         ids=[f"{n}-{json.dumps(o)}" for n, o in FOCUSED])
def test_focused_mutators_match_jax(name, opts):
    """Candidates with a mask installed, swapped for a padded one,
    then cleared — the walk of each package's mutator stays in step.
    afl's deterministic stages ignore the mask; its havoc tail (past
    the 8-byte seed's stages) honors it."""
    ref, port = _pair(name, opts)
    # one batch size throughout: each new size recompiles the JAX side
    n = 650 if name == "afl" and not opts.get("skip_deterministic") \
        else 96
    for m in (ref, port):
        m.set_focus_mask([6, 1, 1, 3])
    _batches_equal(ref, port, [n] * (4 if n == 650 else 2))
    for m in (ref, port):
        m.set_focus_mask([0, 2, 5], pad_pow2=True)
    _batches_equal(ref, port, [n])
    for m in (ref, port):
        m.set_focus_mask(None)
    _batches_equal(ref, port, [n])


def _campaign_parts(monkeypatch):
    """jit_harness + havoc on the CPU with the engine switched to
    ``cuda_fused`` (the fuse decision reads only the engine name; the
    fused and unfused wrappers run their plain versions on CPU
    tensors)."""
    instr = instrumentation_factory(
        "jit_harness", json.dumps({"target": "test"}), device="cpu")
    monkeypatch.setattr(instr, "engine", "cuda_fused")
    mut = mutator_factory("havoc", '{"seed": 11}', b"ABC@", device="cpu")
    drv = driver_factory("file", None, instr, mut, device="cpu")
    return instr, mut, drv


def test_focus_mask_stands_the_fused_path_down(monkeypatch):
    """With a mask installed the driver makes the mutator's focused
    candidates and executes them unfused; once the mask clears the
    fused path runs again."""
    instr, mut, drv = _campaign_parts(monkeypatch)
    assert instr.wants_fused(mut) and drv.supports_fused_multi()
    calls = {"fused": 0}
    real = instr.run_batch_fused

    def counting(*a, **kw):
        calls["fused"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(instr, "run_batch_fused", counting)
    mut.set_focus_mask([0, 3])
    assert not instr.wants_fused(mut)
    assert not drv.supports_fused_multi()
    assert not drv.supports_batch_generations()
    # the candidates the driver ran are the focused mutator's
    twin = mutator_factory("havoc", '{"seed": 11}', b"ABC@", device="cpu")
    twin.set_focus_mask([0, 3])
    out = drv.test_batch(64)
    tb, tl = twin.mutate_batch(64)
    assert calls["fused"] == 0
    assert torch.equal(out.inputs, tb) and torch.equal(out.lengths, tl)
    changed = (out.inputs[:, :4] != torch.tensor(list(b"ABC@"),
                                                  dtype=torch.uint8))
    assert changed.any()
    mut.set_focus_mask(None)
    assert instr.wants_fused(mut) and drv.supports_fused_multi()
    drv.test_batch(64)
    assert calls["fused"] == 1


def test_set_focus_mask_clears_the_prefetch_stash():
    """A stash generated under the old mask is dropped on install."""
    mut = mutator_factory("havoc", '{"seed": 2}', b"ABC@", device="cpu")
    mut.prefetch_batch(16)
    assert mut._stash is not None
    mut.set_focus_mask([1])
    assert mut._stash is None

