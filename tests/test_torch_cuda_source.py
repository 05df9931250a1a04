"""The CUDA kernels' source logic, run on the CPU.

``csrc/vm_kernel.cu`` builds only with nvcc on a card.  Its device
code is plain C++, so here it is compiled for the host with g++ under
a small shim and held, bit for bit, against the plain PyTorch versions
the wrappers take on the CPU.  The shim runs each emulated block as
``blockDim`` host threads: ``__syncthreads`` is a C++20
``std::barrier``, the block's dynamic shared memory one buffer per
block (filled with junk, so nothing may rely on it starting zeroed),
``__funnelshift_l``/``_r`` the funnel shifts they are, ``atomicAdd``
an atomic add, ``__ldg`` a plain load.  So the kernels' shared-memory layout and
synchronisation are exercised too; what nvcc makes of them is checked
on the card by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.models.vm import _run_batch_impl as jax_run
from killerbeez_tpu_torch.models import targets_cgc
from killerbeez_tpu_torch.models.compiler import Assembler
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.ops import _build, prng
from killerbeez_tpu_torch.ops import vm_kernel as vk

torch.set_num_threads(1)

SHIM_HEAD = """
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __restrict__
#define __align__(n) alignas(n)
#define __launch_bounds__(n)
struct alignas(16) int4 { int x, y, z, w; };
struct EmuDim { int x; };
static thread_local EmuDim threadIdx, blockIdx;
static EmuDim gridDim, blockDim;
static thread_local std::barrier<>* emu_bar;
static thread_local unsigned char* emu_smem;
static inline void __syncthreads() { emu_bar->arrive_and_wait(); }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi,
                                       uint32_t s) {
  s &= 31u;
  return s ? (hi << s) | (lo >> (32u - s)) : hi;
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi,
                                       uint32_t s) {
  s &= 31u;
  return s ? (lo >> s) | (hi << (32u - s)) : lo;
}
"""

SHIM_TAIL = """
// Run `body` as a grid of `grid` blocks of `threads` host threads each,
// every block with its own `smem_bytes` of junk-filled shared memory.
template <class F>
void emu_launch(int grid, int threads, int smem_bytes, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    std::vector<int4> smem((smem_bytes + 15) / 16 + 1);
    std::memset(smem.data(), 0xA5, smem.size() * sizeof(int4));
    std::barrier<> bar(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, b, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_bar = &bar;
        emu_smem = reinterpret_cast<unsigned char*>(smem.data());
        body();
      });
    for (auto& th : pool) th.join();
  }
}

Out emu_out(void* status, void* exit_code, void* counts, void* steps,
            void* hash) {
  return Out{(int*)status, (int*)exit_code, (uint8_t*)counts, (int*)steps,
             (int64_t*)hash};
}

}  // namespace

extern "C" int emu_fuzz(int threads, int table_mode, const void* instrs,
    int ni, int instrs_shared, int state_shared, const void* table, int nb,
    const void* ring, int L, const void* ring_lens, const void* sel,
    const void* base_key, const void* its, int sp, int B, int mem_size,
    int max_steps,
    int n_edges, void* scratch, int cols, void* status, void* exit_code,
    void* counts, void* steps, void* hash, void* bufs, void* lens) {
  const Plan p = make_plan(threads, ni, instrs_shared, nb, table_mode,
                           state_shared, n_edges, L, 1);
  const Out out = emu_out(status, exit_code, counts, steps, hash);
  const int grid = (B + threads - 1) / threads;
  emu_launch(grid, threads, p.bytes, [&] {
    auto go = [&](auto* tag) {
      using TabT = std::remove_pointer_t<decltype(tag)>;
      (state_shared ? kbz_fuzz_kernel<TabT, true>
                    : kbz_fuzz_kernel<TabT, false>)(
          p, (const int4*)instrs, ni, table, nb, (const uint8_t*)ring, L,
          (const int*)ring_lens, (const int*)sel, (const int64_t*)base_key,
          (const int64_t*)its, sp, B,
          mem_size, max_steps, n_edges, (int*)scratch, cols, out,
          (uint8_t*)bufs, (int*)lens);
    };
    if (table_mode == TABLE_U8) go((uint8_t*)nullptr);
    else if (table_mode == TABLE_U16) go((uint16_t*)nullptr);
    else go((int*)nullptr);
  });
  return p.bytes;
}

extern "C" int emu_vm(int threads, int resident, int table_mode,
    const void* instrs, int ni, int instrs_shared, int state_shared,
    const void* table, int nb, const void* inputs, int L,
    const void* lengths, const void* lanes, const void* n_lanes,
    int n_threads, int mem_size, int max_steps, int n_edges, void* scratch,
    int cols, void* status, void* exit_code, void* counts, void* steps,
    void* hash) {
  const Plan p = make_plan(threads, ni, instrs_shared, nb, table_mode,
                           state_shared, n_edges, L, 0);
  const Out out = emu_out(status, exit_code, counts, steps, hash);
  const int grid = vm_grid(n_threads, threads, resident, lanes != nullptr);
  emu_launch(grid, threads, p.bytes, [&] {
    auto go = [&](auto* tag) {
      using TabT = std::remove_pointer_t<decltype(tag)>;
      (state_shared ? kbz_vm_kernel<TabT, true>
                    : kbz_vm_kernel<TabT, false>)(p, (const int4*)instrs,
          ni, table, nb,
          (const uint8_t*)inputs, L, (const int*)lengths, (const int*)lanes,
          (const int*)n_lanes, n_threads, mem_size, max_steps, n_edges,
          (int*)scratch, cols, out);
    };
    if (table_mode == TABLE_U8) go((uint8_t*)nullptr);
    else if (table_mode == TABLE_U16) go((uint16_t*)nullptr);
    else go((int*)nullptr);
  });
  return p.bytes;
}

extern "C" int emu_state_shared(int smem_max, int ni, int instrs_shared,
    int nb, int table_mode, int n_edges, int L, int fuzz) {
  return lane_state_shared(smem_max, ni, instrs_shared, nb, table_mode,
                           n_edges, L, fuzz);
}

extern "C" void emu_threefry_words(uint32_t k0, uint32_t k1, int n,
                                   uint32_t* out) {
  for (int j = 0; j < n; ++j) out[j] = threefry_word(k0, k1, (uint32_t)j);
}

extern "C" void emu_fold_in(uint32_t k0, uint32_t k1, int n,
                            const uint32_t* data, uint32_t* out) {
  for (int i = 0; i < n; ++i)
    threefry_fold_in(k0, k1, data[i], out[2 * i], out[2 * i + 1]);
}
"""

SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"
HOST_CODE = "// ---- host launch code"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src = (_build.CSRC / "vm_kernel.cu").read_text()
    assert src.count(SMEM_DECL) == 2 and HOST_CODE in src
    src = src.replace("#include <cuda_runtime.h>", "#include <type_traits>")
    src = src.replace(SMEM_DECL, "unsigned char* smem = emu_smem;")
    # the device code, without the host's launch functions
    src = src[:src.index(HOST_CODE)]
    d = tmp_path_factory.mktemp("emu")
    (d / "emu.cpp").write_text(SHIM_HEAD + src + SHIM_TAIL)
    subprocess.run([cxx, "-O1", "-std=c++20", "-pthread", "-shared",
                    "-fPIC", "-o", str(d / "emu.so"), str(d / "emu.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(d / "emu.so"))
    u32 = ctypes.c_uint32
    lib.emu_threefry_words.argtypes = (u32, u32, ctypes.c_int,
                                       ctypes.c_void_p)
    lib.emu_fold_in.argtypes = (u32, u32, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p)
    return lib


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _setup(name, B=256, L=64):
    prog = get_target(name)
    fn = targets_cgc.VM_SEEDS.get(name)
    sb = fn[0]() if fn else b"ABC@"
    seed = torch.zeros(L, dtype=torch.uint8)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    its = torch.arange(1000, 1000 + B, dtype=torch.int64)
    return (prog, torch.as_tensor(prog.instrs), torch.as_tensor(
        prog.edge_table), seed, len(sb), prng.key(7), its)


def _outputs(b, e, zero_counts=False):
    """Output tensors filled with junk: the kernels write every row.
    With the lane state in device memory the wrapper zeroes the counts
    first (the kernels count into the output rows)."""
    return (torch.full((b,), -7, dtype=torch.int32),
            torch.full((b,), -7, dtype=torch.int32),
            torch.full((b, e + 1), 0 if zero_counts else 0xA5,
                       dtype=torch.uint8),
            torch.full((b,), -7, dtype=torch.int32),
            torch.full((b,), -7, dtype=torch.int64))


def _same(out, ref):
    for a, r in zip(out, ref):
        assert torch.equal(a.to(torch.int64), r.to(torch.int64))


def _scratch(prog, cols, state_rows):
    """The wrapper's device scratch, junk-filled: the scratch cells,
    then the lanes' buffers when they are not in shared memory."""
    rows = max(prog.mem_size + state_rows, 1)
    return torch.full((rows, cols), -3, dtype=torch.int32), cols


def _fuzz(emu, prog, instrs, table, seed, n, key, its, steps, threads=64,
          sp=4, state_shared=True, n_edges=None, ring=None):
    """kbz_fuzz_kernel's source against the plain version, its seed the
    one-slot ring of ``seed`` (``n`` bytes) or, given, the (ring,
    lengths, slot) triple ``ring``."""
    ring = ring or vk.seed_ring(seed, n)
    B, L = its.shape[0], ring[0].shape[1]
    n_edges = prog.n_edges if n_edges is None else n_edges
    lay = vk.program_layout(instrs, table, n_edges, "cpu")
    out = _outputs(B, n_edges, zero_counts=not state_shared)
    bufs = torch.full((B, L), 0xA5, dtype=torch.uint8)
    lens = torch.full((B,), -7, dtype=torch.int32)
    scratch, cols = _scratch(prog, B,
                             0 if state_shared else 2 * ((L + 3) // 4))
    emu.emu_fuzz(threads, lay.table_mode, _p(lay.instrs),
                 lay.instrs.shape[0], int(lay.instrs_shared),
                 int(state_shared), _p(lay.table), lay.table.shape[1],
                 _p(ring[0]), L, _p(ring[1]), _p(ring[2]), _p(key), _p(its),
                 sp, B, prog.mem_size, steps, n_edges, _p(scratch), cols,
                 *map(_p, out), _p(bufs), _p(lens))
    ref, rbufs, rlens = vk.fuzz_batch_plain(instrs, table, *ring, key, its,
                                            prog.mem_size, steps, n_edges,
                                            sp)
    _same(out, ref)
    assert torch.equal(bufs, rbufs) and torch.equal(lens, rlens)
    return lay, ref


def _mutants(prog, instrs, table, seed, n, key, its):
    """The plain fused step's mutants at a budget of one VM step: the
    inputs the VM kernel's cases run."""
    _, bufs, lens = vk.fuzz_batch_plain(instrs, table, *vk.seed_ring(seed, n),
                                        key, its, prog.mem_size, 1,
                                        prog.n_edges, 4)
    return bufs, lens


def _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes, threads=64,
        resident=3, state_shared=True, n_edges=None):
    """kbz_vm_kernel's source against the plain version; ``resident``
    stands for the blocks the card holds at once (the persistent
    grid of a lane list)."""
    B, L = bufs.shape
    n_edges = prog.n_edges if n_edges is None else n_edges
    lay = vk.program_layout(instrs, table, n_edges, "cpu")
    n_threads = B if lanes is None else lanes.shape[0]
    # the wrapper's contract: without a list the kernel writes every
    # row; with one, the rest start zeroed
    out = _outputs(B, n_edges, zero_counts=not state_shared) \
        if lanes is None else \
        tuple(torch.zeros_like(t) for t in _outputs(B, n_edges))
    scratch, cols = _scratch(prog, (B + threads - 1) // threads * threads,
                             0 if state_shared else (L + 3) // 4)
    emu.emu_vm(threads, resident, lay.table_mode, _p(lay.instrs),
               lay.instrs.shape[0], int(lay.instrs_shared),
               int(state_shared), _p(lay.table), lay.table.shape[1],
               _p(bufs), L, _p(lens), _p(lanes),
               _p(None if n_lanes is None else n_lanes.reshape(1)),
               n_threads, prog.mem_size, prog.max_steps, n_edges,
               _p(scratch), cols, *map(_p, out))
    ref = vk.run_batch_plain(instrs, table, bufs, lens, prog.mem_size,
                             prog.max_steps, n_edges, lanes, n_lanes)
    _same(out, ref)
    return lay, ref


NAMES = ["test", "hang", "libtest", "tlvstack_vm", "imgparse_vm",
         "rledec_vm"]


@pytest.mark.parametrize("name", NAMES)
def test_fuzz_kernel_source_matches_plain(name, emu):
    prog, instrs, table, seed, n, key, its = _setup(name)
    for steps in (prog.max_steps, 16):
        lay, _ = _fuzz(emu, prog, instrs, table, seed, n, key, its, steps)
        assert lay.table_mode == vk.TABLE_U8 and lay.instrs_shared


@pytest.mark.parametrize("name", NAMES)
def test_vm_kernel_source_matches_plain(name, emu):
    prog, instrs, table, seed, n, key, its = _setup(name)
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    B = bufs.shape[0]
    mask = torch.from_numpy(np.random.default_rng(1).random(B) < 0.3)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes)


@pytest.mark.parametrize("threads", [32, 128])
def test_fuzz_kernel_ragged_last_block(threads, emu):
    """B = 200 is no multiple of the block size: the last block's
    rows, and only they, are written from its partial range."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=200)
    _fuzz(emu, prog, instrs, table, seed, n, key, its, 64, threads=threads)


@pytest.mark.parametrize("L", [30, 61])
def test_fuzz_kernel_buffer_length_not_a_word_multiple(L, emu):
    """L % 4 != 0: the last word of a lane's buffer is partial, so the
    full-buffer passes build it byte by byte and the rows are copied
    out bytewise."""
    prog, instrs, table, seed, n, key, its = _setup("rledec_vm", B=96,
                                                    L=L)
    _fuzz(emu, prog, instrs, table, seed, n, key, its, prog.max_steps,
          threads=32)
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    _vm(emu, prog, instrs, table, bufs, lens, None, None, threads=32)


@pytest.mark.parametrize("sel", [0, 3])
@pytest.mark.parametrize("state_shared", [True, False])
def test_fuzz_kernel_reads_its_seed_from_the_ring(sel, state_shared, emu):
    """The ring form: the seed is row ``sel`` of a ring u8[6, 64] whose
    rows are random bytes, with ``lens[sel]`` (30) below L; the kernel
    loads the row and the length on the device, with the seed staged in
    shared memory or read from device memory."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=96)
    rng = np.random.default_rng(20 + sel)
    L = seed.shape[0]
    ring = torch.from_numpy(rng.integers(0, 256, (6, L), dtype=np.uint8))
    ring[sel, :n] = seed[:n]
    lens = torch.from_numpy(rng.integers(1, L, 6).astype(np.int32))
    lens[sel] = n
    triple = (ring, lens, torch.tensor(sel, dtype=torch.int32))
    _, ref = _fuzz(emu, prog, instrs, table, seed, n, key, its,
                   prog.max_steps, threads=32, state_shared=state_shared,
                   ring=triple)
    # the other rows differ, so a kernel that read another row would
    # have disagreed with the plain version
    other = vk.fuzz_batch_plain(instrs, table, ring, lens,
                                torch.tensor(sel ^ 1, dtype=torch.int32),
                                key, its, prog.mem_size, prog.max_steps,
                                prog.n_edges, 4)[0]
    assert not torch.equal(other.path_hash, ref.path_hash)


def test_fuzz_kernel_scratch_in_device_memory(emu):
    """The lanes' buffers as lane-minor rows of the device scratch,
    after the scratch cells, and the counts straight in the output rows
    (the plan for inputs too long for shared memory) give the same
    results."""
    prog, instrs, table, seed, n, key, its = _setup("imgparse_vm", B=96)
    _fuzz(emu, prog, instrs, table, seed, n, key, its, prog.max_steps,
          threads=32, state_shared=False)


def test_vm_kernel_scratch_in_device_memory(emu):
    prog, instrs, table, seed, n, key, its = _setup("rledec_vm", B=160)
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    mask = torch.from_numpy(np.random.default_rng(4).random(160) < 0.4)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes,
            threads=32, resident=2, state_shared=False)


# the H100's opt-in shared memory per block (227 KB)
H100_SMEM_MAX = 232448


def _state_shared(emu, instrs, table, n_edges, L, fuzz):
    lay = vk.program_layout(instrs, table, n_edges, "cpu")
    return bool(emu.emu_state_shared(
        H100_SMEM_MAX, lay.instrs.shape[0], int(lay.instrs_shared),
        lay.table.shape[1], lay.table_mode, n_edges, L, int(fuzz)))


@pytest.mark.parametrize("case", [
    ("fuzz", 64, None, True),      # the flagship: everything in shared
    ("vm", 64, None, True),
    ("vm", 1024, None, True),      # one buffer of 1 KB still fits
    ("fuzz", 1024, None, False),   # two do not, beside 187 B of counts
    ("fuzz", 4096, None, False),
    ("vm", 4096, None, False),
    ("fuzz", 64, 8000, False),     # counts rows of 8001 B
    ("vm", 64, 8000, False),
])
def test_lane_state_placement(case, emu):
    """The plan keeps each lane's buffers and counts row in shared
    memory when a block of 128 threads holds them, on the H100's 227 KB
    per block, and puts them in device memory otherwise."""
    kernel, L, n_edges, shared = case
    prog = get_target("tlvstack_vm")
    instrs = torch.as_tensor(prog.instrs)
    table = torch.as_tensor(prog.edge_table)
    assert _state_shared(emu, instrs, table, n_edges or prog.n_edges, L,
                         kernel == "fuzz") is shared


def test_long_inputs_keep_lane_state_in_device_memory(emu):
    """L = 4096 (a 2 KB seed at ratio 2): the lanes' buffers do not fit
    shared memory, so both kernels take the device-memory plan and stay
    bit-identical to the plain versions."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=64,
                                                    L=4096)
    seed[n:2048] = torch.from_numpy(
        np.random.default_rng(8).integers(0, 256, 2048 - n, dtype=np.uint8))
    n = 2048
    assert not _state_shared(emu, instrs, table, prog.n_edges, 4096, True)
    assert not _state_shared(emu, instrs, table, prog.n_edges, 4096, False)
    _fuzz(emu, prog, instrs, table, seed, n, key, its, prog.max_steps,
          threads=32, state_shared=False)
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    mask = torch.from_numpy(np.random.default_rng(9).random(64) < 0.5)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes,
            threads=32, resident=1, state_shared=False)


def test_many_edges_keep_lane_state_in_device_memory(emu):
    """8000 edges (tlvstack_vm's table, with counts rows of 8001 bytes):
    the counts rows do not fit shared memory, so both kernels count
    straight into the output rows."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=64)
    assert not _state_shared(emu, instrs, table, 8000, 64, True)
    assert not _state_shared(emu, instrs, table, 8000, 64, False)
    lay, _ = _fuzz(emu, prog, instrs, table, seed, n, key, its,
                   prog.max_steps, threads=32, state_shared=False,
                   n_edges=8000)
    assert lay.table_mode == vk.TABLE_U16
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    mask = torch.from_numpy(np.random.default_rng(10).random(64) < 0.5)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes,
            threads=32, resident=1, state_shared=False, n_edges=8000)


def test_instructions_and_table_in_device_memory(emu, monkeypatch):
    """With a shared-memory cap below both tables, the instructions and
    the edge table are both read from device memory."""
    monkeypatch.setattr(vk, "TABLE_SMEM_MAX", 1024)
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=96)
    lay, _ = _fuzz(emu, prog, instrs, table, seed, n, key, its,
                   prog.max_steps, threads=32)
    assert lay.table_mode == vk.TABLE_DEVICE and not lay.instrs_shared
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    mask = torch.from_numpy(np.random.default_rng(6).random(96) < 0.5)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes,
            threads=32, resident=2)


@pytest.mark.parametrize("listed", ["none", "fewer_than_length",
                                    "more_slots_than_threads"])
def test_vm_kernel_lane_lists(listed, emu):
    """A lane list with 0 entries (every lane stays zero), with fewer
    entries than its length (the tail of the list is ignored), and
    with more entries than the persistent grid has threads (threads
    take slot s + grid * blockDim)."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=300)
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    rng = np.random.default_rng(5)
    B = bufs.shape[0]
    if listed == "none":
        lanes, n_lanes = vk.compact_lanes(torch.zeros(B, dtype=torch.bool))
    elif listed == "fewer_than_length":
        lanes, n_lanes = vk.compact_lanes(
            torch.from_numpy(rng.random(B) < 0.2))
        # junk past the count must not be run
        lanes[int(n_lanes):] = torch.from_numpy(
            rng.integers(0, B, B - int(n_lanes)).astype(np.int32))
    else:
        lanes = torch.from_numpy(rng.permutation(B)[:250].astype(np.int32))
        n_lanes = torch.tensor(250, dtype=torch.int32)
    _, ref = _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes,
                 threads=32, resident=3)
    if listed == "none":
        assert int(ref.steps.sum()) == 0 and int(ref.counts.sum()) == 0


def test_fixedform_reads_its_table_from_device_memory(emu):
    """fixedform_vm's 343 x 342 edge table does not fit the block's
    shared memory even as u16: both kernels read it from device memory
    (the template instance on int32)."""
    prog, instrs, table, seed, n, key, its = _setup("fixedform_vm", B=96, L=128)
    lay, _ = _fuzz(emu, prog, instrs, table, seed, n, key, its,
                   prog.max_steps, threads=32)
    assert lay.table_mode == vk.TABLE_DEVICE and lay.instrs_shared
    bufs, lens = _mutants(prog, instrs, table, seed, n, key, its)
    mask = torch.from_numpy(np.random.default_rng(2).random(96) < 0.5)
    for lanes, n_lanes in ((None, None), vk.compact_lanes(mask)):
        _vm(emu, prog, instrs, table, bufs, lens, lanes, n_lanes,
            threads=32, resident=2)


def test_u16_edge_table_path(emu):
    """The u16 shared-memory table: the layout a program with 256 or
    more edges gets (asked for here with tlvstack_vm's table and
    n_edges 300), run through the kernel's u16 instance."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", B=64)
    lay = vk.program_layout(instrs, table, 300, "cpu")
    assert lay.table_mode == vk.TABLE_U16 and lay.table.dtype == torch.int16
    assert torch.equal(lay.table.to(torch.int32), table.to(torch.int32))
    out = _outputs(64, prog.n_edges)
    bufs = torch.zeros((64, 64), dtype=torch.uint8)
    lens = torch.zeros(64, dtype=torch.int32)
    scratch, cols = _scratch(prog, 64, 0)
    ring = vk.seed_ring(seed, n)
    emu.emu_fuzz(32, vk.TABLE_U16, _p(lay.instrs), lay.instrs.shape[0], 1,
                 1, _p(lay.table), lay.table.shape[1], _p(ring[0]), 64,
                 _p(ring[1]), _p(ring[2]), _p(key), _p(its), 4, 64,
                 prog.mem_size, prog.max_steps, prog.n_edges, _p(scratch),
                 cols, *map(_p, out), _p(bufs), _p(lens))
    ref, rbufs, rlens = vk.fuzz_batch_plain(instrs, table, *ring, key, its,
                                            prog.mem_size, prog.max_steps,
                                            prog.n_edges)
    _same(out, ref)
    assert torch.equal(bufs, rbufs) and torch.equal(lens, rlens)


# --------------------------------------------------------------------
# hand-assembled programs: edge counts that wrap, all eight registers
# --------------------------------------------------------------------

def _prog_wrap():
    """A loop whose back edge runs in[0] + 200 times: past 255 for most
    inputs, so its u8 count wraps."""
    a = Assembler("count_wrap", mem_size=4, max_steps=2048)
    a.block()
    a.ldi(1, 0)
    a.ldb(1, 1)
    a.addi(1, 1, 200)
    a.label("loop")
    a.block()
    a.addi(1, 1, -1)
    a.br("ge", 1, 0, "loop")
    a.halt(4)
    return a.build()


def _prog_reg_stress():
    """All eight registers written and read by ALU, BR, LDM and STM.
    Round t folds register t into the others, then uses it as the
    index register: the other seven are stored to memory, compared in
    pairs (the branches make their values visible as edges), and loaded
    back in a rotated order, so values travel between registers through
    memory; a last store at a data-made index crashes some lanes."""
    a = Assembler("reg_stress", mem_size=16, max_steps=2048)
    a.block()
    for k in range(8):
        a.ldi(k, k)
        a.ldb(k, k)                            # r_k = in[k]
    ops = ("add", "xor", "mul", "sub", "or", "add", "shr", "xor")
    cmps = ("eq", "ne", "lt", "ge")
    for t in range(8):
        others = [(t + 1 + i) % 8 for i in range(7)]
        for i, k in enumerate(others):
            a.alu(ops[(i + t) % 8], k, k, others[(i + 3) % 7])
        a.alu("xor", others[0], others[0], t)
        for i, k in enumerate(others):
            a.ldi(t, i)
            a.stm(t, k)                        # mem[i] = r_k
        for i, k in enumerate(others):
            a.br(cmps[(i + t) % 4], k, others[(i + 2) % 7], f"s{t}_{i}")
            a.block()
            a.label(f"s{t}_{i}")
        for i, k in enumerate(others):
            a.ldi(t, (i + t + 1) % 7)
            a.ldm(k, t)                        # r_k = mem[i + t + 1]
        a.alu("add", t, others[1], others[4])
    a.ldi(1, 2)
    a.ldb(2, 1)
    a.alu("xor", 0, 0, 2)
    a.ldi(1, 31)
    a.alu("and", 0, 0, 1)
    a.stm(0, 1)                                # crashes when r0 >= 16
    a.halt(5)
    return a.build()


@pytest.mark.parametrize("which", ["count_wrap", "reg_stress"])
def test_hand_assembled_programs_source_plain_and_jax(which, emu):
    """The kernels' source, the plain VM and the JAX VM agree on the
    programs most likely to show a register or count fault."""
    prog = _prog_wrap() if which == "count_wrap" else _prog_reg_stress()
    rng = np.random.default_rng(11)
    B, L = 192, 16
    bufs = torch.from_numpy(rng.integers(0, 256, (B, L)).astype(np.uint8))
    lens = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32))
    instrs = torch.as_tensor(prog.instrs)
    table = torch.as_tensor(prog.edge_table)
    _, ref = _vm(emu, prog, instrs, table, bufs, lens, None, None,
                 threads=32, resident=2)
    jref = jax_run(jnp.asarray(prog.instrs), jnp.asarray(prog.edge_table),
                   jnp.asarray(bufs.numpy()), jnp.asarray(lens.numpy()),
                   prog.mem_size, prog.max_steps, prog.n_edges, False)
    for f in ("status", "exit_code", "counts", "steps", "path_hash"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jref, f)).astype(np.int64),
            getattr(ref, f).numpy().astype(np.int64), err_msg=f)
    if which == "count_wrap":
        # the back edge runs in[0] + 200 times: past 255 on most lanes
        assert int((bufs[:, 0].to(torch.int64) + 200 > 255).sum()) > 100
    else:
        assert {0, 2} <= set(ref.status.tolist())
        assert len(set(ref.path_hash.tolist())) > 20
    # and through the fused kernel, from a seed of these bytes
    seed = bufs[0].clone()
    its = torch.arange(64, dtype=torch.int64)
    _fuzz(emu, prog, instrs, table, seed, L, prng.key(3), its,
          prog.max_steps, threads=32)


# --------------------------------------------------------------------
# the kernel's threefry against ops/prng.py and jax.random
# --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, -1])
def test_threefry_words_match_prng_and_jax(seed, emu):
    rng = np.random.default_rng(seed & 0xFFFF)
    data = rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    key = prng.key(seed)
    # fold_in, three ways
    out = np.zeros((16, 2), np.uint32)
    emu.emu_fold_in(int(key[0]), int(key[1]), 16, data.ctypes.data,
                    out.ctypes.data)
    tkeys = prng.fold_in(key, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(out.astype(np.int64), tkeys.numpy())
    jkey = jax.random.key(seed)
    for i in range(0, 16, 5):
        jk = jax.random.key_data(jax.random.fold_in(jkey,
                                                    jnp.uint32(data[i])))
        np.testing.assert_array_equal(out[i], np.asarray(jk))
    # the words of each folded key, three ways
    n = 136
    for i in range(0, 16, 5):
        words = np.zeros(n, np.uint32)
        emu.emu_threefry_words(int(out[i, 0]), int(out[i, 1]), n,
                               words.ctypes.data)
        np.testing.assert_array_equal(
            words.astype(np.int64), prng.bits(tkeys[i], n).numpy())
        jk = jax.random.fold_in(jkey, jnp.uint32(data[i]))
        np.testing.assert_array_equal(
            words, np.asarray(jax.random.bits(jk, (17, 8), jnp.uint32))
            .reshape(-1))
