"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need a CUDA card:
they carry the ``device`` marker and skip without one (the CPU tier
holds the plain versions to the JAX package instead).  On a machine
with a card: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.
"""

import pytest
import torch

from killerbeez_tpu_torch.models import targets_cgc
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.ops import vm_kernel as vk

pytestmark = pytest.mark.device

TARGETS = ["test", "hang", "libtest", "tlvstack_vm", "imgparse_vm",
           "rledec_vm", "fixedform_vm"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _setup(name, dev, B=2048, L=64):
    prog = get_target(name)
    fn = targets_cgc.VM_SEEDS.get(name)
    sb = fn[0]() if fn else b"ABC@"
    seed = torch.zeros(L, dtype=torch.uint8, device=dev)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    its = torch.arange(500, 500 + B, dtype=torch.int64, device=dev)
    return (prog, torch.as_tensor(prog.instrs, device=dev),
            torch.as_tensor(prog.edge_table, device=dev), seed, len(sb),
            prng.key(3, device=dev), its)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.to(torch.int64), y.to(torch.int64))


@pytest.mark.parametrize("name", TARGETS)
def test_fuzz_kernel_matches_plain(name, cuda):
    L = 128 if name == "fixedform_vm" else 64
    prog, instrs, table, seed, n, key, its = _setup(name, cuda, L=L)
    for steps in (prog.max_steps, 16):
        args = (instrs, table, *vk.seed_ring(seed, n), key, its,
                prog.mem_size, steps, prog.n_edges, 4)
        res, bufs, lens = vk.fuzz_batch(*args)
        ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
        _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])


@pytest.mark.parametrize("sel", [0, 3])
def test_fuzz_kernel_ring_form_matches_plain(sel, cuda):
    """The seed as row ``sel`` of a ring of six random rows, its length
    (30) below L = 64, read by the kernel on the device."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", cuda)
    gen = torch.Generator().manual_seed(40 + sel)
    ring = torch.randint(0, 256, (6, 64), dtype=torch.uint8, generator=gen)
    lens = torch.randint(1, 64, (6,), dtype=torch.int32, generator=gen)
    ring, lens = ring.to(cuda), lens.to(cuda)
    ring[sel] = seed
    lens[sel] = n
    sel_t = torch.tensor(sel, dtype=torch.int32, device=cuda)
    for steps in (prog.max_steps, 16):
        args = (instrs, table, ring, lens, sel_t, key, its, prog.mem_size,
                steps, prog.n_edges, 4)
        got = vk.fuzz_batch(*args)
        ref = vk.fuzz_batch_plain(*args)
        _equal(list(got[0]) + list(got[1:]), list(ref[0]) + list(ref[1:]))
        # the same seed given alone: the same lanes
        one = vk.fuzz_batch(instrs, table, *vk.seed_ring(seed, n), key, its,
                            prog.mem_size, steps, prog.n_edges, 4)
        _equal(list(one[0]) + list(one[1:]), list(got[0]) + list(got[1:]))


@pytest.mark.parametrize("name", TARGETS)
def test_vm_kernel_matches_plain(name, cuda):
    L = 128 if name == "fixedform_vm" else 64
    prog, instrs, table, seed, n, key, its = _setup(name, cuda, L=L)
    _, bufs, lens = vk.fuzz_batch(instrs, table, *vk.seed_ring(seed, n),
                                  key, its, prog.mem_size, 1, prog.n_edges,
                                  4)
    _both_kernels(instrs, table, bufs, lens, prog.mem_size,
                  prog.max_steps, prog.n_edges, cuda)


def _both_kernels(instrs, table, bufs, lens, mem_size, max_steps, n_edges,
                  dev):
    """kbz_vm_kernel without and with a lane list against the plain VM;
    returns whether its lanes' state was in shared memory."""
    args = (instrs, table, bufs, lens, mem_size, max_steps, n_edges)
    _equal(vk.run_batch(*args), vk.run_batch_plain(*args))
    lanes, n_lanes = vk.compact_lanes(
        torch.rand(bufs.shape[0], device=dev) < 0.3)
    _equal(vk.run_batch(*args, lanes=lanes, n_lanes=n_lanes),
           vk.run_batch_plain(*args, lanes=lanes, n_lanes=n_lanes))
    return vk.LAST_CONFIG["kbz_vm_kernel"]["lane_state_shared"]


@pytest.mark.parametrize("shape", ["L4096", "edges8000"])
def test_lane_state_in_device_memory(shape, cuda):
    """Inputs of 4096 bytes, or 8000 edges: the lanes' buffers or counts
    rows do not fit shared memory, so both kernels keep them in device
    memory, and stay bit-identical to the plain versions."""
    L, n_edges = (4096, None) if shape == "L4096" else (64, 8000)
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", cuda,
                                                    L=L)
    n_edges = n_edges or prog.n_edges
    args = (instrs, table, *vk.seed_ring(seed, n), key, its, prog.mem_size,
            prog.max_steps, n_edges, 4)
    res, bufs, lens = vk.fuzz_batch(*args)
    assert not vk.LAST_CONFIG["kbz_fuzz_kernel"]["lane_state_shared"]
    ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
    _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])
    assert not _both_kernels(instrs, table, bufs, lens, prog.mem_size,
                             prog.max_steps, n_edges, cuda)


def test_instructions_and_table_in_device_memory(cuda, monkeypatch):
    """With a shared-memory cap below both tables, both kernels read the
    instructions and the edge table from device memory."""
    monkeypatch.setattr(vk, "TABLE_SMEM_MAX", 1024)
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", cuda)
    lay = vk.program_layout(instrs, table, prog.n_edges, cuda)
    assert lay.table_mode == vk.TABLE_DEVICE and not lay.instrs_shared
    args = (instrs, table, *vk.seed_ring(seed, n), key, its, prog.mem_size,
            prog.max_steps, prog.n_edges, 4)
    res, bufs, lens = vk.fuzz_batch(*args)
    ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
    _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])
    assert _both_kernels(instrs, table, bufs, lens, prog.mem_size,
                         prog.max_steps, prog.n_edges, cuda)


def test_fixedform_takes_the_device_memory_table(cuda):
    """fixedform_vm's edge table is too large for shared memory: the
    kernels read it from device memory (and tlvstack_vm's is staged)."""
    for name, mode in (("fixedform_vm", vk.TABLE_DEVICE),
                       ("tlvstack_vm", vk.TABLE_U8)):
        prog = get_target(name)
        lay = vk.program_layout(torch.as_tensor(prog.instrs),
                                torch.as_tensor(prog.edge_table),
                                prog.n_edges, cuda)
        assert lay.table_mode == mode


def test_fused_dispatch_never_waits_for_the_card(cuda, monkeypatch):
    """A superbatch dispatch, and the start of its results' host
    copies, only enqueue work: nothing in them waits for the card (a
    host sync raises under sync debug mode "error"), so the loop keeps
    its pipeline of batches in flight.  Nor does it draw havoc words
    (``prng.bits``): the fused kernel computes each lane's own."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.ops.host_copy import HostCopy
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    drv = driver_factory("file", None, instr, mut)

    def dispatch():
        packed, _bufs, _lens, compact = drv.test_batch_fused_multi(2048, 2)
        return [HostCopy(t) for t in (packed, *compact)]

    dispatch()                   # first use: the kernel build, allocations
    torch.cuda.synchronize()
    bits_calls = []
    real_bits = prng.bits

    def counting_bits(*args, **kwargs):
        bits_calls.append(args)
        return real_bits(*args, **kwargs)
    monkeypatch.setattr(prng, "bits", counting_bits)
    torch.cuda.set_sync_debug_mode("error")
    try:
        copies = dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert copies[0].materialize().shape == (2, 2048)
    assert mut.iteration == 4 * 2048
    # the fused kernel drew every lane's havoc words itself
    assert bits_calls == []


def test_rotation_never_waits_for_the_card(cuda, tmp_path):
    """Corpus feedback at -fb 8 over four rotation boundaries (rr: the
    base seed, then admitted arms): each seed swap uploads through
    pinned staging with a non-blocking copy, and nothing at a boundary
    waits for the card (a host sync raises under sync debug mode
    "error"; the loop's only waits are the CUDA events of its host
    copies, which that mode does not count)."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    width = mut.max_length
    drv = driver_factory("file", None, instr, mut)
    fz = Fuzzer(drv, output_dir=str(tmp_path), batch_size=2048,
                feedback=8, scheduler="rr")
    fz.run(8 * 2048)       # first use: the kernel build, allocations
    torch.cuda.synchronize()
    assert fz.scheduler.arms and fz.scheduler.rotations == 0
    seeds = set()
    real_set_input = mut.set_input

    def set_input(buf, keep_length=False):
        seeds.add(bytes(buf))
        real_set_input(buf, keep_length)
    mut.set_input = set_input
    torch.cuda.set_sync_debug_mode("error")
    try:
        fz.run(40 * 2048)    # to 40 batches: boundaries after 8, 16, 24, 32
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fz.scheduler.rotations == 4
    assert len(seeds) >= 2 and mut.max_length == width
    assert mut.iteration == 40 * 2048


def test_generations_dispatch_never_waits_for_the_card(cuda):
    """A -G 4 dispatch (four generations, each picking its seed slot on
    the card, the fused kernel reading it from the device ring, triage,
    the findings-ring append and the ring admission) and the start of
    its report's host copies only enqueue work: nothing waits for the
    card (a host sync raises under sync debug mode "error")."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    drv = driver_factory("file", None, instr, mut)
    # first use: the kernel build, allocations; the ring fills
    drv.test_batch_generations(2048, 4, pad_to=2048).materialize()
    torch.cuda.synchronize()
    before = dict(vk.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = drv.test_batch_generations(2000, 4, pad_to=2048).prefetch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h = out.materialize()
    assert h.g == 4 and h.gen0 == 4 and h.n_real == 2000
    assert vk.LAUNCHES["kbz_fuzz_kernel"] == before["kbz_fuzz_kernel"] + 4
    assert vk.LAUNCHES["kbz_vm_kernel"] == before["kbz_vm_kernel"] + 4
    assert int(h.ring_filled.sum()) > 1 and int(h.fr_ptr) > 0
    assert mut.iteration == 2048 * 4 + 2000 * 4
