"""The port's branch-distance engines against the JAX package's, bit for
bit: ``run_batch_distances`` with and without operand capture and
``run_batch_distance`` on every built-in KBVM target (the five
``VMResult`` fields, the float32 distances and the int32 captures), the
engine's ``VMResult`` against ``run_batch(record_stream=False)``, the
branch-distance table itself, and the refusal of an empty spec list.
Tolerance: none (the distances are the same float32 subtract, abs, max
and +1 in the same order).  The card's run is held to the CPU's in
``tests/test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_cgc as jax_cgc
from killerbeez_tpu.models import vm as jax_vm
from killerbeez_tpu.search.objective import edge_objectives as jax_objectives
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.models import vm
from killerbeez_tpu_torch.models.compiler import Assembler
from killerbeez_tpu_torch.search.objective import edge_objectives

torch.set_num_threads(1)

NAMES = sorted(targets.target_names())
FIELDS = ("status", "exit_code", "counts", "steps", "path_hash")


def _specs(prog, cap=12):
    """Deciding-branch specs of the program's static edges (every
    compare direction the search tier asks for), at most ``cap``."""
    specs = []
    for f, t in zip(prog.edge_from, prog.edge_to):
        specs += [o.spec() for o in edge_objectives(prog, (int(f), int(t)))]
    # spread the cap over the whole universe, not its first block
    step = max(1, len(specs) // cap)
    return tuple(specs[::step][:cap])


def _batch(name, seed=7, B=192, L=40):
    """Seed-like inputs with a fifth of the bytes randomized, plus
    random lengths (empty lanes included)."""
    rng = np.random.default_rng(seed)
    fn = jax_cgc.VM_SEEDS.get(name)
    sb = (fn[0]() if fn else b"ABCD")[:L]
    inputs = np.zeros((B, L), np.uint8)
    inputs[:, :len(sb)] = np.frombuffer(sb, np.uint8)
    noise = rng.random((B, L)) < 0.2
    inputs = np.where(noise, rng.integers(0, 256, (B, L)),
                      inputs).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    return inputs, lengths


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_result(ref, out):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)).astype(np.int64),
            getattr(out, f).numpy().astype(np.int64), f)


@pytest.mark.parametrize("capture", [False, True], ids=["plain", "capture"])
@pytest.mark.parametrize("name", NAMES)
def test_distances_match_jax(name, capture):
    prog = targets.get_target(name)
    specs = _specs(prog)
    if not specs:
        pytest.fail(f"{name} has no deciding branches")
    inputs, lengths = _batch(name)
    ref = jax_vm.run_batch_distances(
        jax_targets.get_target(name), jnp.asarray(inputs),
        jnp.asarray(lengths), specs, capture_operands=capture)
    out = vm.run_batch_distances(prog, torch.from_numpy(inputs),
                                 torch.from_numpy(lengths), specs,
                                 capture_operands=capture)
    assert len(ref) == len(out) == (4 if capture else 2)
    _same_result(ref[0], out[0])
    for r, o in zip(ref[1:], out[1:]):
        _bits_equal(r, o.numpy())
    # the engine samples something on these inputs, and not everything
    d = out[1].numpy()
    assert (d < np.float32(vm.DIST_UNREACHED)).any()


@pytest.mark.parametrize("name", NAMES)
def test_distance_engine_result_is_run_batch(name):
    """The distance engine's VMResult is the production engine's."""
    prog = targets.get_target(name)
    inputs, lengths = _batch(name, seed=11)
    x, y = torch.from_numpy(inputs), torch.from_numpy(lengths)
    res, _ = vm.run_batch_distances(prog, x, y, _specs(prog, cap=3))
    ref = vm.run_batch(prog, x, y, record_stream=False)
    for f in FIELDS:
        assert torch.equal(getattr(ref, f), getattr(res, f)), f


@pytest.mark.parametrize("name", ["magicsum_vm", "imgparse_vm", "test"])
def test_single_branch_wrapper_matches_jax(name):
    prog = targets.get_target(name)
    jprog = jax_targets.get_target(name)
    inputs, lengths = _batch(name, seed=3)
    for f, t in list(zip(prog.edge_from, prog.edge_to))[:6]:
        for obj, jobj in zip(edge_objectives(prog, (int(f), int(t))),
                             jax_objectives(jprog, (int(f), int(t)))):
            assert obj.spec() == jobj.spec()
            kw = dict(zip(("branch_pc", "from_idx", "sel", "x_idx",
                           "y_idx"), obj.spec()))
            rres, rd = jax_vm.run_batch_distance(
                jprog, jnp.asarray(inputs), jnp.asarray(lengths), **kw)
            ores, od = vm.run_batch_distance(
                prog, torch.from_numpy(inputs), torch.from_numpy(lengths),
                **kw)
            _same_result(rres, ores)
            _bits_equal(rd, od.numpy())


def _toy(cmp):
    """byte 0 <cmp> 42 decides block 2."""
    a = Assembler(f"dist_{cmp}")
    a.block()
    a.ldi(2, 0)
    a.ldb(1, 2)
    a.ldi(2, 42)
    a.br(cmp, 1, 2, "win")
    a.block()
    a.halt(0)
    a.label("win")
    a.block()
    a.halt(0)
    return a.build()


@pytest.mark.parametrize("cmp", ["eq", "ne", "lt", "ge"])
def test_distance_table_every_compare(cmp):
    """Each compare direction, both successors: the table's zeros, its
    magnitudes and the captured operands equal the JAX package's."""
    prog = _toy(cmp)
    jprog = jax_vm.Program(instrs=prog.instrs.copy(), name=prog.name,
                           mem_size=prog.mem_size,
                           max_steps=prog.max_steps)
    rows = np.zeros((6, 8), np.uint8)
    rows[:, 0] = [0, 7, 41, 42, 43, 255]
    lens = np.array([1, 1, 1, 1, 1, 0], np.int32)
    specs = tuple(o.spec() for e in ((0, 1), (0, 2))
                  for o in edge_objectives(prog, e))
    assert len(specs) == 2
    ref = jax_vm.run_batch_distances(jprog, jnp.asarray(rows),
                                     jnp.asarray(lens), specs,
                                     capture_operands=True)
    out = vm.run_batch_distances(prog, torch.from_numpy(rows),
                                 torch.from_numpy(lens), specs,
                                 capture_operands=True)
    _same_result(ref[0], out[0])
    for r, o in zip(ref[1:], out[1:]):
        _bits_equal(r, o.numpy())
    # distance 0 exactly where the branch goes the edge's way
    d = out[1].numpy()
    assert ((d == 0).sum(axis=1) == 1).all()


def test_wide_operands_round_as_float32():
    """Operands past 2^24 round in float32 before the subtract; the
    magnitudes must still equal the JAX package's bit for bit."""
    a = Assembler("wide")
    a.block()
    a.ldi(2, 0)
    a.ldb(1, 2)
    a.ldi(3, 24)
    a.alu("shl", 1, 1, 3)
    a.ldi(2, 1)
    a.ldb(4, 2)
    a.alu("add", 1, 1, 4)
    a.ldi(2, 0x1234)                # r2 = 0x12345679, built by parts
    a.ldi(3, 16)
    a.alu("shl", 2, 2, 3)
    a.ldi(3, 0x5679)
    a.alu("or", 2, 2, 3)
    a.br("eq", 1, 2, "win")
    a.block()
    a.halt(0)
    a.label("win")
    a.block()
    a.halt(0)
    prog = a.build()
    jprog = jax_vm.Program(instrs=prog.instrs.copy(), name=prog.name,
                           mem_size=prog.mem_size,
                           max_steps=prog.max_steps)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (64, 8)).astype(np.uint8)
    lens = np.full(64, 8, np.int32)
    specs = tuple(o.spec() for o in edge_objectives(prog, (0, 2)))
    ref = jax_vm.run_batch_distances(jprog, jnp.asarray(rows),
                                     jnp.asarray(lens), specs)
    out = vm.run_batch_distances(prog, torch.from_numpy(rows),
                                 torch.from_numpy(lens), specs)
    _bits_equal(ref[1], out[1].numpy())


def test_empty_specs_are_refused():
    prog = targets.get_target("test")
    x = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="at least one branch spec"):
        vm.run_batch_distances(prog, x, torch.ones(2, dtype=torch.int32),
                               ())

