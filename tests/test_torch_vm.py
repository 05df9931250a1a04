"""The PyTorch port's KBVM against the JAX package's, bit for bit:
program tables of every registered target, the five VMResult fields
of the plain torch engine on mutant batches, and hand-assembled
programs that hit the semantics most likely to diverge (int32
overflow, logical shifts of negatives, out-of-range memory, a jump
past the end onto a BLOCK, the step cap)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_cgc as jax_cgc
from killerbeez_tpu.models.vm import _run_batch_impl as jax_run
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.models.compiler import Assembler
from killerbeez_tpu_torch.models.vm import Program, run_batch

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

FIELDS = ("status", "exit_code", "counts", "steps", "path_hash")
TABLES = ("instrs", "edge_from", "edge_to", "edge_slot", "edge_table")


def _mutant_batch(name, rng, B, L):
    seed_fn = jax_cgc.VM_SEEDS.get(name)
    seed = (seed_fn[0]() if seed_fn else b"ABC@")[:L]
    inputs = np.zeros((B, L), np.uint8)
    inputs[:, :len(seed)] = np.frombuffer(seed, np.uint8)
    mask = rng.random((B, L)) < 0.2
    inputs = np.where(mask, rng.integers(0, 256, (B, L)),
                      inputs).astype(np.uint8)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    return inputs, lengths


def _assert_same_run(prog, inputs, lengths):
    ref = jax_run(jnp.asarray(prog.instrs), jnp.asarray(prog.edge_table),
                  jnp.asarray(inputs), jnp.asarray(lengths),
                  prog.mem_size, prog.max_steps, prog.n_edges, False)
    out = run_batch(prog, torch.from_numpy(inputs),
                    torch.from_numpy(lengths))
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)).astype(np.int64),
            getattr(out, f).numpy().astype(np.int64),
            err_msg=f"{prog.name}: {f} diverged")
    return out


@pytest.mark.parametrize("name", targets.target_names())
def test_program_tables_match(name):
    ref = jax_targets.get_target(name)
    prog = targets.get_target(name)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(ref, f), getattr(prog, f),
                                      err_msg=f"{name}: {f}")
    assert prog.block_ids == ref.block_ids
    assert prog.modules == ref.modules
    assert (prog.mem_size, prog.max_steps) == (ref.mem_size, ref.max_steps)


@pytest.mark.parametrize("name", ["tlvstack_vm", "test"])
def test_program_from_arrays_recomputes_tables(name):
    """A JAX Program's plain fields carried across: the port derives
    the same edge tables itself."""
    ref = jax_targets.get_target(name)
    raw = ref.instrs.copy()
    # compute_edges rewrites BLOCK rows' b field; start from zeros so
    # the port has to derive it again
    raw[raw[:, 0] == 1, 2] = 0
    prog = Program.from_arrays(raw, ref.name, ref.mem_size,
                               ref.max_steps, ref.n_blocks, ref.block_ids,
                               ref.modules)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(ref, f), getattr(prog, f))


def test_npz_program_file_loads(tmp_path):
    """A compiled .npz program loads through the port's
    load_program_from_options with the reference's tables."""
    ref = jax_targets.get_target("imgparse_vm")
    path = tmp_path / "prog.npz"
    np.savez(path, instrs=ref.instrs, name=ref.name,
             mem_size=ref.mem_size, max_steps=ref.max_steps,
             n_blocks=ref.n_blocks, block_ids=np.asarray(ref.block_ids))
    prog = targets.load_program_from_options(
        {"program_file": str(path), "max_steps": 99}, "")
    jprog = jax_targets.load_program_from_options(
        {"program_file": str(path), "max_steps": 99}, "")
    assert prog.max_steps == jprog.max_steps == 99
    for f in TABLES:
        np.testing.assert_array_equal(getattr(jprog, f), getattr(prog, f))


@pytest.mark.parametrize("name", ["test", "hang", "libtest", "tlvstack_vm",
                                  "imgparse_vm", "rledec_vm"])
def test_vm_matches_jax_engine(name):
    rng = np.random.default_rng(sum(name.encode()))
    prog = targets.get_target(name)
    inputs, lengths = _mutant_batch(name, rng, 256, 48)
    _assert_same_run(prog, inputs, lengths)


def _emit_bits(a, reg, tag):
    """Make bits 0-3 and 28-31 of ``reg`` observable as blocks
    (scratch r1, r5, r6)."""
    for k in (0, 1, 2, 3, 28, 29, 30, 31):
        a.ldi(1, k)
        a.alu("shr", 6, reg, 1)
        a.ldi(5, 1)
        a.alu("and", 6, 6, 5)
        a.br("eq", 6, 0, f"{tag}_{k}")
        a.block()
        a.label(f"{tag}_{k}")


def _load_inputs(a):
    """r2 = in[0] << 24 (large, often negative), r3 = in[1] - 128
    (shift counts below 0 and above 31)."""
    a.block()
    a.ldi(1, 0)
    a.ldb(2, 1)
    a.ldi(1, 24)
    a.alu("shl", 2, 2, 1)
    a.ldi(1, 1)
    a.ldb(3, 1)
    a.addi(3, 3, -128)


def _prog_alu():
    a = Assembler("alu_wrap", mem_size=8, max_steps=1024)
    _load_inputs(a)
    for op in ("add", "sub", "mul", "shl", "shr"):
        a.alu(op, 7, 2, 3)
        _emit_bits(a, 7, op)
    a.addi(7, 2, (1 << 23) + 12345)
    _emit_bits(a, 7, "addi")
    a.alu("mul", 7, 2, 2)
    _emit_bits(a, 7, "sq")
    a.halt(3)
    return a.build()


def _prog_memory():
    a = Assembler("mem_oob", mem_size=8, max_steps=256)
    _load_inputs(a)
    a.ldi(1, 2)
    a.ldb(4, 1)
    a.addi(4, 4, -124)             # store index in [-124, 131]
    a.stm(4, 3)
    a.block()
    a.ldi(1, 3)
    a.ldb(5, 1)
    a.addi(5, 5, -124)             # load index in [-124, 131]
    a.ldm(7, 5)
    _emit_bits(a, 7, "ld")
    a.halt(1)
    return a.build()


def _prog_jump(target):
    a = Assembler(f"jump_{target}", mem_size=8, max_steps=64)
    _load_inputs(a)
    a.ldi(1, 2)
    a.ldb(4, 1)
    a.ldi(5, 128)
    a.br("lt", 4, 5, "out")        # about half the lanes jump away
    a.halt(2)
    a.label("out")
    a.jmp(target)
    a.block()                      # the last row: fetched at the clip
    return a.build()


def _prog_step_cap():
    a = Assembler("step_cap", mem_size=8, max_steps=300)
    a.block()
    a.ldi(1, 0)
    a.ldb(1, 1)                    # loop count = in[0]
    a.label("loop")
    a.block()
    a.addi(1, 1, -1)
    a.br("ge", 1, 0, "loop")
    a.halt(4)
    return a.build()


@pytest.mark.parametrize("which", ["alu", "memory", "jump_past_end",
                                   "jump_negative", "step_cap"])
def test_hand_assembled_edges(which):
    if which == "alu":
        prog = _prog_alu()
    elif which == "memory":
        prog = _prog_memory()
    elif which == "jump_past_end":
        prog = _prog_jump(10_000)
    elif which == "jump_negative":
        prog = _prog_jump(-5)
    else:
        prog = _prog_step_cap()
    rng = np.random.default_rng(7)
    B, L = 256, 8
    inputs = rng.integers(0, 256, (B, L)).astype(np.uint8)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    out = _assert_same_run(prog, inputs, lengths)
    statuses = set(out.status.tolist())
    if which in ("memory", "jump_past_end", "jump_negative"):
        assert 2 in statuses                     # some lanes crash
    if which == "step_cap":
        assert 3 in statuses                     # some lanes run out
    if which == "jump_past_end":
        # the clipped fetch ran the last BLOCK: outside the static
        # universe, so it lands in the overflow column
        assert int(out.counts[:, -1].sum()) > 0
