"""The port's fused fuzz path, driven by its plain versions on the CPU,
against the JAX package: the fused step equals JAX havoc_at followed
by the JAX VM (all seven outputs), the two-phase glue equals a single
phase, and the K-step superbatch equals K sequential JAX steps
(packed verdicts, compact reports and virgin maps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.instrumentation import jit_harness as jax_jh
from killerbeez_tpu.instrumentation.base import pack_verdicts
from killerbeez_tpu.models import targets_cgc as jax_cgc
from killerbeez_tpu.models.vm import _run_batch_impl as jax_run
from killerbeez_tpu.ops import mutate_core as jax_mc
from killerbeez_tpu.ops.static_triage import make_static_maps
from killerbeez_tpu_torch.instrumentation import jit_harness
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.ops import prng, vm_kernel

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

FIELDS = ("status", "exit_code", "counts", "steps", "path_hash")


def _seed(name, L):
    fn = jax_cgc.VM_SEEDS.get(name)
    seed = fn[0]() if fn else b"ABC@"
    buf = np.zeros(L, np.uint8)
    buf[:len(seed)] = np.frombuffer(seed, np.uint8)
    return buf, len(seed)


def _jax_mutants(seed_buf, seed_len, seed, its, sp):
    base = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.asarray(its.astype(np.uint32)))
    return jax.vmap(lambda k: jax_mc.havoc_at(
        jnp.asarray(seed_buf), jnp.int32(seed_len), k, stack_pow2=sp))(keys)


def _tables(prog):
    return (torch.as_tensor(prog.instrs), torch.as_tensor(prog.edge_table))


def _ring(seed_buf, seed_len):
    """The fused kernel's one-slot seed ring of a numpy seed."""
    return vm_kernel.seed_ring(torch.from_numpy(seed_buf), seed_len)


@pytest.mark.parametrize("name", ["test", "tlvstack_vm"])
def test_fused_step_matches_havoc_then_vm(name):
    prog = targets.get_target(name)
    seed_buf, seed_len = _seed(name, 64)
    B, sp = 128, 4
    its = np.arange(B, dtype=np.int64)
    bufs_r, lens_r = _jax_mutants(seed_buf, seed_len, 3, its, sp)
    ref = jax_run(jnp.asarray(prog.instrs), jnp.asarray(prog.edge_table),
                  bufs_r, lens_r, prog.mem_size, prog.max_steps,
                  prog.n_edges, False)
    res, bufs, lens = vm_kernel.fuzz_batch(
        *_tables(prog), *_ring(seed_buf, seed_len), prng.key(3),
        torch.from_numpy(its), prog.mem_size, prog.max_steps, prog.n_edges,
        stack_pow2=sp)
    np.testing.assert_array_equal(np.asarray(bufs_r), bufs.numpy())
    np.testing.assert_array_equal(np.asarray(lens_r), lens.numpy())
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)).astype(np.int64),
            getattr(res, f).numpy().astype(np.int64), err_msg=f)


@pytest.mark.parametrize("phase1", [16, -1])
def test_two_phase_equals_single_phase(phase1):
    prog = targets.get_target("tlvstack_vm")
    seed_buf, seed_len = _seed("tlvstack_vm", 64)
    B = 256
    its = torch.arange(B, dtype=torch.int64)
    args = (*_tables(prog), *_ring(seed_buf, seed_len), prng.key(5), its,
            prog.mem_size, prog.max_steps, prog.n_edges)
    one, b1, l1 = vm_kernel.fuzz_batch(*args, stack_pow2=4)
    two, b2, l2 = vm_kernel.fuzz_batch_2phase(*args, stack_pow2=4,
                                              phase1_steps=phase1)
    p1 = phase1 if phase1 > 0 else vm_kernel.auto_phase1_steps(
        prog.max_steps)
    assert int((one.steps > p1).sum()) > 0     # phase 2 had work
    assert torch.equal(b1, b2) and torch.equal(l1, l2)
    for a, b in zip(one, two):
        assert (a is None and b is None) or torch.equal(a, b)


def test_fused_step_draws_no_havoc_words(monkeypatch):
    """The fused path hands the base key and the iteration numbers to
    the fused kernel's wrapper, which draws each lane's words itself:
    the instrumentation draws none (no [B, 136] words tensor)."""
    prog = targets.get_target("tlvstack_vm")
    seed_buf, seed_len = _seed("tlvstack_vm", 64)
    u_slots, seg_id = make_static_maps(prog.edge_slot)
    vb = torch.full((prog.map_size,), 0xFF, dtype=torch.uint8)
    calls = []
    wrapped = jit_harness.fuzz_batch_2phase

    def spy(*args, **kwargs):
        calls.append(args)
        return wrapped(*args, **kwargs)

    def boom(*_a, **_k):
        raise AssertionError("the fused path drew havoc words")

    monkeypatch.setattr(jit_harness, "havoc_words_for_keys", boom,
                        raising=False)
    monkeypatch.setattr(jit_harness, "fuzz_batch_2phase", spy)
    key = prng.key(3)
    its0 = torch.arange(40, 72, dtype=torch.int64)
    jit_harness._fused_fuzz_multi(
        *_tables(prog), torch.from_numpy(u_slots), torch.from_numpy(seg_id),
        _ring(seed_buf, seed_len), key, its0, vb, vb.clone(), vb.clone(),
        prog.mem_size, prog.max_steps, prog.n_edges, False, 4, 2,
        phase1_steps=-1)
    assert len(calls) == 2
    for j, args in enumerate(calls):
        assert args[5] is key
        assert torch.equal(args[6], its0 + j * 32)
        assert not any(torch.is_tensor(a) and a.dim() == 2 and
                       a.shape[1] == 136 for a in args)


def _compact_ref(statuses, new_paths, bufs, lens, cap):
    flags = (statuses != 0) | (new_paths > 0)
    idx = np.flatnonzero(flags)[:cap]
    sel = np.zeros(min(cap, len(flags)), np.int64)
    sel[:len(idx)] = idx
    return sel, bufs[sel], lens[sel], int(flags.sum())


@pytest.mark.parametrize("exact", [False, True])
def test_fused_multi_matches_sequential_jax_steps(exact):
    prog = targets.get_target("tlvstack_vm")
    seed_buf, seed_len = _seed("tlvstack_vm", 64)
    B, K, sp, seed = 96, 3, 4, 3
    its0 = np.arange(1000, 1000 + B, dtype=np.int64)
    u_slots, seg_id = make_static_maps(prog.edge_slot)
    vb = np.full(prog.map_size, 0xFF, np.uint8)
    vc, vh = vb.copy(), vb.copy()

    out = jit_harness._fused_fuzz_multi(
        *_tables(prog), torch.from_numpy(u_slots),
        torch.from_numpy(seg_id), _ring(seed_buf, seed_len),
        prng.key(seed), torch.from_numpy(its0), torch.from_numpy(vb),
        torch.from_numpy(vc), torch.from_numpy(vh), prog.mem_size,
        prog.max_steps, prog.n_edges, exact, sp, K, phase1_steps=-1)
    (tvb, tvc, tvh, packed, bufs, lens, idx, sbufs, slens, count) = out

    jvb, jvc, jvh = jnp.asarray(vb), jnp.asarray(vc), jnp.asarray(vh)
    for j in range(K):
        bj, lj = _jax_mutants(seed_buf, seed_len, seed, its0 + j * B, sp)
        (st, np_, uc, uh, _ex, jvb, jvc, jvh, _c) = jax_jh._fused_step(
            jnp.asarray(prog.instrs), jnp.asarray(prog.edge_table),
            jnp.asarray(u_slots), jnp.asarray(seg_id), bj, lj, jvb, jvc,
            jvh, prog.mem_size, prog.max_steps, prog.n_edges, exact,
            "xla")
        st, np_ = np.asarray(st), np.asarray(np_)
        np.testing.assert_array_equal(
            np.asarray(pack_verdicts(st, np_, np.asarray(uc),
                                     np.asarray(uh))),
            packed[j].numpy())
        np.testing.assert_array_equal(np.asarray(bj), bufs[j].numpy())
        np.testing.assert_array_equal(np.asarray(lj), lens[j].numpy())
        sel, sb, sl, cnt = _compact_ref(st, np_, np.asarray(bj),
                                        np.asarray(lj),
                                        jit_harness.COMPACT_CAP)
        np.testing.assert_array_equal(sel, idx[j].numpy())
        np.testing.assert_array_equal(sb, sbufs[j].numpy())
        np.testing.assert_array_equal(sl, slens[j].numpy())
        assert cnt == int(count[j]) and cnt > 0
    for r, o in ((jvb, tvb), (jvc, tvc), (jvh, tvh)):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


def test_fused_loop_matches_unfused_loop(tmp_path, monkeypatch):
    """The loop's fused paths (the K-step superbatch, then single fused
    steps with their compact reports) write the same findings and
    state as the mutate-then-execute path, here on the CPU."""
    import json

    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    def campaign(out, fused):
        instr = JitHarnessInstrumentation(
            json.dumps({"target": "tlvstack_vm"}), device="cpu")
        if fused:
            monkeypatch.setattr(instr, "wants_fused", lambda m: True)
        mut = HavocMutator('{"seed": 5}', tlvstack_vm_seed(), device="cpu")
        drv = driver_factory("file", None, instr, mut, device="cpu")
        fz = Fuzzer(drv, output_dir=str(out), batch_size=128)
        assert fz._resolve_accumulate() == (8 if fused else 1)
        fz.run(128 * 10)             # one superbatch, two single steps
        found = {d: sorted(p.name for p in (out / d).iterdir())
                 for d in ("crashes", "hangs", "new_paths")}
        return found, instr.get_state(), mut.iteration

    ref = campaign(tmp_path / "plain", False)
    assert campaign(tmp_path / "fused", True) == ref
    assert ref[0]["new_paths"] and ref[2] == 1280


def test_fused_inputs_are_made_on_the_device():
    """A fused dispatch copies nothing from the host: the mutator hands
    out the same cached seed and key tensors until its seed changes,
    and the iteration numbers are made from the first one (uint32
    wrap included)."""
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation('{"target": "test"}', device="cpu")
    mut = HavocMutator('{"seed": 7}', b"ABC@", device="cpu")
    seed, _, key, _ = mut.fused_spec()
    again = mut.fused_spec()
    assert again[0] is seed and again[2] is key
    np.testing.assert_array_equal(seed.numpy(), mut.seed_buf)
    np.testing.assert_array_equal(key.numpy(), [0, 7])
    mut.set_input(b"WXYZ")
    assert bytes(mut.fused_spec()[0].numpy()[:4]) == b"WXYZ"

    start = 2**32 - 2
    ring, _, its, sp = instr._fused_inputs(mut, np.arange(start, start + 4))
    assert its.tolist() == [2**32 - 2, 2**32 - 1, 0, 1] and sp == 4
    assert ring[0].numpy()[0, :4].tobytes() == b"WXYZ"
    assert ring[1].tolist() == [4] and int(ring[2]) == 0
    assert instr._fused_inputs(mut, np.arange(4))[0] is ring
    with pytest.raises(ValueError, match="consecutive"):
        instr._fused_inputs(mut, np.array([0, 2, 3]))
