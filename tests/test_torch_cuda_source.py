"""The CUDA kernels' source logic, run on the CPU.

``csrc/vm_kernel.cu`` builds only with nvcc on a card.  Its device
code is plain C++, so here it is compiled for the host with g++ under
a small shim (CUDA qualifiers dropped, ``__ldg`` a plain load, one
host loop standing in for the grid) and held, bit for bit, against
the plain PyTorch versions the wrappers take on the CPU.  This checks
the kernels' semantics without a card; what nvcc makes of them is
checked on the card by ``chip_smoke.py``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from killerbeez_tpu_torch.models import targets_cgc
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.ops import _build, prng
from killerbeez_tpu_torch.ops import vm_kernel as vk

torch.set_num_threads(1)

SHIM_HEAD = """
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __restrict__
struct int4 { int x, y, z, w; };
struct Dim { int x; };
static Dim blockIdx, blockDim = {1}, threadIdx;
template <class T> T __ldg(const T* p) { return *p; }
"""

SHIM_TAIL = """
}  // namespace
extern "C" void emu_fuzz(const void* instrs, int ni, const void* table,
    int nb, const void* seed, int L, int seed_len, const void* words,
    int n_words, int sp, int B, int mem_size, int max_steps, int n_edges,
    void* scratch, void* mem, void* status, void* exit_code, void* counts,
    void* steps, void* hash, void* bufs, void* lens) {
  for (int t = 0; t < B; ++t) {
    threadIdx.x = t;
    kbz_fuzz_kernel((const int4*)instrs, ni, (const int*)table, nb,
        (const uint8_t*)seed, L, seed_len, (const uint32_t*)words, n_words,
        sp, B, mem_size, max_steps, n_edges, (uint8_t*)scratch, (int*)mem,
        (int*)status, (int*)exit_code, (uint8_t*)counts, (int*)steps,
        (uint32_t*)hash, (uint8_t*)bufs, (int*)lens);
  }
}
extern "C" void emu_vm(const void* instrs, int ni, const void* table,
    int nb, const void* inputs, int L, const void* lengths,
    const void* lanes, const void* n_lanes, int n_threads, int mem_size,
    int max_steps, int n_edges, void* mem, void* status, void* exit_code,
    void* counts, void* steps, void* hash) {
  for (int t = 0; t < n_threads; ++t) {
    threadIdx.x = t;
    kbz_vm_kernel((const int4*)instrs, ni, (const int*)table, nb,
        (const uint8_t*)inputs, L, (const int*)lengths, (const int*)lanes,
        (const int*)n_lanes, n_threads, mem_size, max_steps, n_edges,
        (int*)mem, (int*)status, (int*)exit_code, (uint8_t*)counts,
        (int*)steps, (uint32_t*)hash);
  }
}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src = (_build.CSRC / "vm_kernel.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    # the device code, without the <<<>>> launch wrappers
    src = src[:src.index("int blocks_for(int n)")]
    d = tmp_path_factory.mktemp("emu")
    (d / "emu.cpp").write_text(SHIM_HEAD + src + SHIM_TAIL)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(d / "emu.so"), str(d / "emu.cpp")], check=True)
    return ctypes.CDLL(str(d / "emu.so"))


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _setup(name, B=256, L=64):
    prog = get_target(name)
    fn = targets_cgc.VM_SEEDS.get(name)
    sb = fn[0]() if fn else b"ABC@"
    seed = torch.zeros(L, dtype=torch.uint8)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    words = vk.havoc_words(prng.key(7), B, 4)
    return (prog, torch.as_tensor(prog.instrs), torch.as_tensor(
        prog.edge_table), seed, len(sb), words)


def _outputs(b, e):
    return (torch.zeros(b, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32),
            torch.zeros((b, e + 1), dtype=torch.uint8),
            torch.zeros(b, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32))


def _same(out, ref):
    st, ex, cn, sp, h = out
    for a, r in zip((st, ex, cn, sp, h.to(torch.int64) & 0xFFFFFFFF), ref):
        assert torch.equal(a.to(torch.int64), r.to(torch.int64))


NAMES = ["test", "hang", "libtest", "tlvstack_vm", "imgparse_vm",
         "rledec_vm"]


@pytest.mark.parametrize("name", NAMES)
def test_fuzz_kernel_source_matches_plain(name, emu):
    prog, instrs, table, seed, n, words = _setup(name)
    B, L = words.shape[0], seed.shape[0]
    for steps in (prog.max_steps, 16):
        out = _outputs(B, prog.n_edges)
        bufs = torch.zeros((B, L), dtype=torch.uint8)
        lens = torch.zeros(B, dtype=torch.int32)
        scratch = torch.zeros((B, L), dtype=torch.uint8)
        mem = torch.zeros((prog.mem_size, B), dtype=torch.int32)
        emu.emu_fuzz(_p(instrs), instrs.shape[0], _p(table),
                     table.shape[1], _p(seed), L, n, _p(words),
                     words.shape[1], 4, B, prog.mem_size, steps,
                     prog.n_edges, _p(scratch), _p(mem),
                     *map(_p, out), _p(bufs), _p(lens))
        ref, rbufs, rlens = vk.fuzz_batch_plain(
            instrs, table, seed, n, words, prog.mem_size, steps,
            prog.n_edges, 4)
        _same(out, ref)
        assert torch.equal(bufs, rbufs) and torch.equal(lens, rlens)


@pytest.mark.parametrize("name", NAMES)
def test_vm_kernel_source_matches_plain(name, emu):
    prog, instrs, table, seed, n, words = _setup(name)
    _, bufs, lens = vk.fuzz_batch_plain(instrs, table, seed, n, words,
                                        prog.mem_size, 1, prog.n_edges, 4)
    B, L = bufs.shape
    mask = torch.from_numpy(np.random.default_rng(1).random(B) < 0.3)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        out = _outputs(B, prog.n_edges)
        mem = torch.zeros((prog.mem_size, B), dtype=torch.int32)
        emu.emu_vm(_p(instrs), instrs.shape[0], _p(table), table.shape[1],
                   _p(bufs), L, _p(lens), _p(lanes),
                   _p(None if n_lanes is None else n_lanes.reshape(1)),
                   B, prog.mem_size, prog.max_steps, prog.n_edges,
                   _p(mem), *map(_p, out))
        _same(out, vk.run_batch_plain(instrs, table, bufs, lens,
                                      prog.mem_size, prog.max_steps,
                                      prog.n_edges, lanes, n_lanes))
