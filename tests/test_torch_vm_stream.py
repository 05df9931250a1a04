"""The port's stream-recording KBVM against the JAX package's, bit for
bit: ``run_batch(record_stream=True)`` (all six ``VMResult`` fields,
the edge stream at the global step index with its -1 padding, across
the plain engine's lane retirement), the single-lane reference engine
``_run_one`` against the JAX one and against lane i of the batched
engine, and ``compile_runner``.  Tolerance: none (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_cgc as jax_cgc
from killerbeez_tpu.models import vm as jax_vm
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.models.vm import (
    _run_batch_impl, _run_one, compile_runner, run_batch,
)
from tests.test_torch_vm import (
    _prog_alu, _prog_jump, _prog_memory, _prog_step_cap,
)

torch.set_num_threads(1)

FIELDS = ("status", "exit_code", "counts", "steps", "path_hash",
          "edge_ids")


def _batch(name, rng, B, L):
    seed_fn = jax_cgc.VM_SEEDS.get(name)
    seed = (seed_fn[0]() if seed_fn else b"CG\x02\x04ABCD")[:L]
    inputs = np.zeros((B, L), np.uint8)
    inputs[:, :len(seed)] = np.frombuffer(seed, np.uint8)
    mask = rng.random((B, L)) < 0.2
    inputs = np.where(mask, rng.integers(0, 256, (B, L)),
                      inputs).astype(np.uint8)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    return inputs, lengths


def _jax_stream(prog, inputs, lengths):
    return jax_vm.run_batch(jax_targets.get_target(prog.name)
                            if prog.name in targets.target_names()
                            else _jax_program(prog),
                            jnp.asarray(inputs), jnp.asarray(lengths),
                            record_stream=True)


def _jax_program(prog):
    return jax_vm.Program(instrs=prog.instrs.copy(), name=prog.name,
                          mem_size=prog.mem_size,
                          max_steps=prog.max_steps)


def _same(ref, out, what):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)).astype(np.int64),
            np.asarray(getattr(out, f)).astype(np.int64),
            err_msg=f"{what}: {f} diverged")


@pytest.mark.parametrize("name", ["tlvstack_vm", "fixedform_vm",
                                  "cgc_like"])
def test_record_stream_matches_jax(name):
    rng = np.random.default_rng(sum(name.encode()) + 1)
    prog = targets.get_target(name)
    inputs, lengths = _batch(name, rng, 96,
                             128 if name == "fixedform_vm" else 64)
    ref = _jax_stream(prog, inputs, lengths)
    out = run_batch(prog, torch.from_numpy(inputs),
                    torch.from_numpy(lengths), record_stream=True)
    _same(ref, out, name)
    ids = out.edge_ids.numpy()
    steps = out.steps.numpy()
    # lanes stopped at different steps (retirement ran) and every
    # row's tail past its own step count is the -1 padding
    assert len(set(steps.tolist())) > 4
    for i in range(len(ids)):
        assert (ids[i, steps[i]:] == -1).all()
        assert (ids[i, :steps[i]] >= 0).any()


def test_stream_off_by_default_and_fields_unchanged():
    """The default keeps the port's existing callers' result: no stream,
    and the five other fields equal the recording run's."""
    prog = targets.get_target("tlvstack_vm")
    inputs, lengths = _batch("tlvstack_vm", np.random.default_rng(7),
                             64, 48)
    args = (torch.from_numpy(inputs), torch.from_numpy(lengths))
    plain = run_batch(prog, *args)
    rec = run_batch(prog, *args, record_stream=True)
    assert plain.edge_ids is None
    for f in FIELDS[:5]:
        assert torch.equal(getattr(plain, f), getattr(rec, f)), f


@pytest.mark.parametrize("which", ["alu", "memory", "jump_past_end",
                                   "jump_negative", "step_cap"])
def test_record_stream_hand_assembled(which):
    prog = {"alu": _prog_alu, "memory": _prog_memory,
            "jump_past_end": lambda: _prog_jump(10_000),
            "jump_negative": lambda: _prog_jump(-5),
            "step_cap": _prog_step_cap}[which]()
    rng = np.random.default_rng(len(which))
    inputs = rng.integers(0, 256, (64, 8)).astype(np.uint8)
    lengths = rng.integers(1, 9, 64).astype(np.int32)
    ref = _jax_stream(prog, inputs, lengths)
    out = run_batch(prog, torch.from_numpy(inputs),
                    torch.from_numpy(lengths), record_stream=True)
    _same(ref, out, which)


@pytest.mark.parametrize("name", ["tlvstack_vm", "cgc_like", "test",
                                  "alu", "jump_past_end", "step_cap"])
def test_run_one_matches_jax_and_batch_lanes(name):
    """The single-lane reference engine equals the JAX ``_run_one`` and
    lane i of the batched engine, stream included."""
    hand = {"alu": _prog_alu, "jump_past_end": lambda: _prog_jump(10_000),
            "step_cap": _prog_step_cap}
    prog = hand[name]() if name in hand else targets.get_target(name)
    jprog = _jax_program(prog) if name in hand \
        else jax_targets.get_target(name)
    rng = np.random.default_rng(sum(name.encode()) + 2)
    inputs, lengths = _batch(name, rng, 6, 32)
    batch = run_batch(prog, torch.from_numpy(inputs),
                      torch.from_numpy(lengths), record_stream=True)
    for i in range(len(inputs)):
        ref = jax_vm._run_one(
            jnp.asarray(jprog.instrs), jnp.asarray(jprog.edge_table),
            jprog.n_edges, jprog.mem_size, jprog.max_steps,
            jnp.asarray(inputs[i]), jnp.int32(lengths[i]))
        one = _run_one(prog.instrs, prog.edge_table, prog.n_edges,
                       prog.mem_size, prog.max_steps,
                       torch.from_numpy(inputs[i]), int(lengths[i]))
        _same(ref, one, f"{name} lane {i}")
        lane = type(batch)(*(getattr(batch, f)[i] for f in FIELDS))
        _same(lane, one, f"{name} batch lane {i}")


def test_compile_runner_matches_jax():
    prog = targets.get_target("cgc_like")
    inputs, lengths = _batch("cgc_like", np.random.default_rng(3), 32, 24)
    ref = jax_vm.compile_runner(jax_targets.get_target("cgc_like"))(
        jnp.asarray(inputs), jnp.asarray(lengths))
    runner = compile_runner(prog)
    out = runner(torch.from_numpy(inputs), torch.from_numpy(lengths))
    _same(ref, out, "compile_runner")
    quiet = compile_runner(prog, record_stream=False)(
        torch.from_numpy(inputs), torch.from_numpy(lengths))
    assert quiet.edge_ids is None
    ref_plain = _run_batch_impl(torch.as_tensor(prog.instrs),
                                torch.as_tensor(prog.edge_table),
                                torch.from_numpy(inputs),
                                torch.from_numpy(lengths), prog.mem_size,
                                prog.max_steps, prog.n_edges)
    for f in FIELDS[:5]:
        assert torch.equal(getattr(quiet, f), getattr(ref_plain, f))
