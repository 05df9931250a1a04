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
           "rledec_vm"]


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
    words = vk.havoc_words(prng.key(3, device=dev), B, 4)
    return (prog, torch.as_tensor(prog.instrs, device=dev),
            torch.as_tensor(prog.edge_table, device=dev), seed, len(sb),
            words)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.to(torch.int64), y.to(torch.int64))


@pytest.mark.parametrize("name", TARGETS)
def test_fuzz_kernel_matches_plain(name, cuda):
    prog, instrs, table, seed, n, words = _setup(name, cuda)
    for steps in (prog.max_steps, 16):
        args = (instrs, table, seed, n, words, prog.mem_size, steps,
                prog.n_edges, 4)
        res, bufs, lens = vk.fuzz_batch(*args)
        ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
        _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])


@pytest.mark.parametrize("name", TARGETS)
def test_vm_kernel_matches_plain(name, cuda):
    prog, instrs, table, seed, n, words = _setup(name, cuda)
    _, bufs, lens = vk.fuzz_batch(instrs, table, seed, n, words,
                                  prog.mem_size, 1, prog.n_edges, 4)
    args = (instrs, table, bufs, lens, prog.mem_size, prog.max_steps,
            prog.n_edges)
    _equal(vk.run_batch(*args), vk.run_batch_plain(*args))
    lanes, n_lanes = vk.compact_lanes(
        torch.rand(bufs.shape[0], device=cuda) < 0.3)
    _equal(vk.run_batch(*args, lanes=lanes, n_lanes=n_lanes),
           vk.run_batch_plain(*args, lanes=lanes, n_lanes=n_lanes))


def test_fused_dispatch_never_waits_for_the_card(cuda):
    """A superbatch dispatch, and the start of its results' host
    copies, only enqueue work: nothing in them waits for the card (a
    host sync raises under sync debug mode "error"), so the loop keeps
    its pipeline of batches in flight."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.fuzzer.loop import _HostCopy
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
        return [_HostCopy(t) for t in (packed, *compact)]

    dispatch()                   # first use: the kernel build, allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        copies = dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert copies[0].materialize().shape == (2, 2048)
    assert mut.iteration == 4 * 2048
