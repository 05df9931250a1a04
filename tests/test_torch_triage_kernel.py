"""The throughput-triage kernels (``csrc/triage.cu``) against
``static_triage_plain``, bit for bit: rets, uc, uh and all three maps.

Three tiers:
  * the kernels' source on the CPU: the device code compiled for the
    host with g++ under a shim that runs each block as ``blockDim``
    host threads and each warp's intrinsics (ballot, match, reduce,
    shuffle) over a barrier of its 32 threads, blocks one after the
    other;
  * the wrapper's CPU side: the slot -> edges table against seg_id's
    fold, the CPU dispatch (the plain version, no launch), the hash as
    one XOR against ``stream_hash``;
  * the kernels on a CUDA card (the ``device`` marker; they skip
    without one): ``python -m pytest --noconftest
    tests/test_torch_triage_kernel.py -q`` there.
Scenarios: random counts with slot collisions and wrapping sums,
crash/hang mixes, a batch whose lanes all share one hash, a batch with
no active lane, fresh and partly-seen maps, B not a multiple of the
block, and the (E, U) of tlvstack_vm, of fixedform_vm (the largest
built-in target; the zoo's are smaller) and of tables too large for
shared memory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.ops import _build, sparse_coverage
from killerbeez_tpu_torch.ops import static_triage as st
from killerbeez_tpu_torch.ops import vm_kernel as vk

torch.set_num_threads(1)

MAP = 1 << 16

SHIM_HEAD = """
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __restrict__
#define __align__(n) alignas(n)
#define __launch_bounds__(n)
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
static inline uint4 make_uint4(unsigned x, unsigned y, unsigned z,
                               unsigned w) { return uint4{x, y, z, w}; }
struct EmuDim { int x; };
static thread_local EmuDim threadIdx, blockIdx;
static EmuDim gridDim, blockDim;
struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t v[32];
};
static thread_local std::barrier<>* emu_bar;
static thread_local EmuWarp* emu_warp;
static thread_local unsigned char* emu_smem;
static inline void __syncthreads() { emu_bar->arrive_and_wait(); }
// a warp intrinsic: every thread of the warp posts its value, all read
// them, and nobody posts the next value before all have read
static inline const uint64_t* emu_post(uint64_t x) {
  emu_warp->v[threadIdx.x & 31] = x;
  emu_warp->bar.arrive_and_wait();
  return emu_warp->v;
}
static inline void emu_read() { emu_warp->bar.arrive_and_wait(); }
static inline unsigned __ballot_sync(unsigned m, int p) {
  const uint64_t* v = emu_post(p != 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (((m >> i) & 1u) && v[i]) r |= 1u << i;
  emu_read();
  return r;
}
static inline unsigned __match_any_sync(unsigned m, unsigned x) {
  const uint64_t* v = emu_post(x);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (((m >> i) & 1u) && (unsigned)v[i] == x) r |= 1u << i;
  emu_read();
  return r;
}
static inline unsigned __reduce_xor_sync(unsigned m, unsigned x) {
  const uint64_t* v = emu_post(x);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if ((m >> i) & 1u) r ^= (unsigned)v[i];
  emu_read();
  return r;
}
static inline unsigned __reduce_or_sync(unsigned m, unsigned x) {
  const uint64_t* v = emu_post(x);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if ((m >> i) & 1u) r |= (unsigned)v[i];
  emu_read();
  return r;
}
static inline int __shfl_sync(unsigned, int x, int src) {
  const uint64_t* v = emu_post((uint32_t)x);
  const int r = (int)(uint32_t)v[src & 31];
  emu_read();
  return r;
}
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static inline int __clz(int x) {
  return x ? __builtin_clz((unsigned)x) : 32;
}
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
static inline unsigned long long atomicCAS(unsigned long long* p,
                                           unsigned long long c,
                                           unsigned long long v) {
  __atomic_compare_exchange_n(p, &c, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return c;
}
static inline unsigned long long atomicMin(unsigned long long* p,
                                           unsigned long long v) {
  unsigned long long o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < o && !__atomic_compare_exchange_n(
                      p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return o;
}
static inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
"""

SHIM_TAIL = """
// Run `body` as a grid of `grid` blocks of `threads` host threads each,
// one block after the other, every block with its own `smem_bytes` of
// junk-filled shared memory and a barrier per warp.
template <class F>
void emu_launch(int grid, int threads, int smem_bytes, F body) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    std::vector<int4> smem((smem_bytes + 15) / 16 + 1);
    std::memset(smem.data(), 0xA5, smem.size() * sizeof(int4));
    std::barrier<> bar(threads);
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w < threads / 32; ++w)
      warps.emplace_back(new EmuWarp);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, b, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_bar = &bar;
        emu_warp = warps[t / 32].get();
        emu_smem = reinterpret_cast<unsigned char*>(smem.data());
        body();
      });
    for (auto& th : pool) th.join();
  }
}

extern "C" void emu_triage(int threads, const void* counts, int row, int B,
    const void* slots, const void* edges, int U, int E, const void* u_slots,
    const void* vb, const void* vc, const void* vh, int map_bytes,
    const void* crash, const void* hang, void* keys, void* mins,
    unsigned cap, unsigned epoch, void* lane_slot, void* lane_nov,
    void* gacc, void* gany, void* rets, void* uc, void* uh, void* ob,
    void* oc, void* oh, int* plan) {
  const TriagePlan p = triage_plan(B, U, E, threads);
  LaneArgs la{(const uint8_t*)counts, row, B, U, E, (const int4*)slots,
              (const int*)edges, (const uint8_t*)vb, (const uint8_t*)vc,
              (const uint8_t*)vh, (const uint8_t*)crash,
              (const uint8_t*)hang, (unsigned long long*)keys,
              (unsigned long long*)mins, cap, epoch, (int*)lane_slot,
              (uint8_t*)lane_nov, (unsigned*)gacc, (unsigned*)gany};
  emu_launch(p.lanes_grid, threads, p.stage_bytes, [&] {
    if (p.staged) kbz_triage_lanes<true>(la);
    else kbz_triage_lanes<false>(la);
  });
  ResolveArgs ra{(const uint8_t*)counts, row, B, U, (const int4*)slots,
                 (const int*)edges, (const unsigned long long*)mins, cap,
                 epoch, (const int*)lane_slot, (const uint8_t*)lane_nov,
                 (int*)rets, (uint8_t*)uc, (uint8_t*)uh, (unsigned*)gacc,
                 (unsigned*)gany, p.acc_shared};
  emu_launch(p.resolve_grid, threads, p.acc_bytes,
             [&] { kbz_triage_resolve(ra); });
  MapsArgs ma{(const uint8_t*)vb, (const uint8_t*)vc, (const uint8_t*)vh,
              map_bytes / 4, (const int*)u_slots, U, (const unsigned*)gacc,
              (const unsigned*)gany, (uint8_t*)ob, (uint8_t*)oc,
              (uint8_t*)oh};
  emu_launch(1, threads, 0, [&] { kbz_triage_maps(ma); });
  plan[0] = p.staged;
  plan[1] = p.acc_shared;
}
"""

SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"
HOST_CODE = "// ---- host launch code"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    src = (_build.CSRC / "triage.cu").read_text()
    assert src.count(SMEM_DECL) == 2 and HOST_CODE in src
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src.replace(SMEM_DECL, "unsigned char* smem = emu_smem;")
    src = src[:src.index(HOST_CODE)]
    d = tmp_path_factory.mktemp("emu_triage")
    (d / "emu.cpp").write_text(SHIM_HEAD + src + SHIM_TAIL)
    subprocess.run([cxx, "-O1", "-std=c++20", "-pthread", "-shared",
                    "-fPIC", "-o", str(d / "emu.so"), str(d / "emu.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(d / "emu.so"))
    P, I, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.emu_triage.argtypes = (I, P, I, I, P, P, I, I, P, P, P, P, I, P, P,
                               P, P, U32, U32, P, P, P, P, P, P, P, P, P,
                               P, P)
    lib.emu_triage.restype = None
    return lib


def _scenario(case, rng, B=300, E=60, n_slots=40, edge_slot=None):
    """(edge_slot, counts, crash, hang, vb, vc, vh) for one scenario:
    slot collisions, sums that wrap at 256, repeated lanes."""
    if edge_slot is None:
        edge_slot = rng.integers(0, n_slots, E).astype(np.int32)
        edge_slot[:3] = MAP - 1
    E = len(edge_slot)
    counts = rng.integers(0, 9, (B, E + 1)).astype(np.uint8)
    counts[rng.random((B, E + 1)) < 0.7] = 0
    counts[:, :4] = rng.integers(0, 255, (B, 4))
    r = B // 5
    counts[B // 2:B // 2 + r] = counts[:r]
    statuses = rng.choice([FUZZ_NONE, FUZZ_CRASH, FUZZ_HANG], B,
                          p=[0.5, 0.3, 0.2])
    vb = np.full(MAP, 0xFF, np.uint8)
    vc, vh = vb.copy(), vb.copy()
    if case == "seen":
        u = np.unique(edge_slot)
        vb[u] = rng.integers(0, 256, len(u))
        vc[u] = rng.integers(0, 256, len(u))
        vc[rng.integers(0, MAP, 500)] = 0xFE
        vh = vh & 0xFE
    elif case == "hot_key":
        counts[:] = counts[7]
    elif case == "no_active":
        # every lane's classes already seen, no crash or hang
        counts[:] = counts[3]
        statuses[:] = FUZZ_NONE
        us, seg = st.make_static_maps(edge_slot)
        by = st.counts_by_slot(torch.from_numpy(counts[:1]),
                               torch.from_numpy(seg), len(us))
        cls = st.classify_counts(by)[0].numpy()
        vb[us] = vb[us] & ~cls
    return (edge_slot, counts, statuses == FUZZ_CRASH,
            statuses == FUZZ_HANG, vb, vc, vh)


# two class rows over 8 slots whose dedup hashes are equal (0x1d3e6811),
# as hit counts: the second lane dedups against the first although its
# path differs, exactly as stream_hash has it
COLLISION = ([4, 32, 1, 0, 128, 1, 1, 8], [8, 32, 128, 8, 8, 3, 2, 32])


def _collision(rng, B=100):
    edge_slot = np.arange(10, 90, 10, dtype=np.int32)
    counts = rng.integers(0, 4, (B, 9)).astype(np.uint8)
    counts[:, 8] = 0
    counts[5, :8], counts[9, :8] = COLLISION
    crash = np.zeros(B, bool)
    crash[[5, 9]] = True
    vb = np.full(MAP, 0xFF, np.uint8)
    return edge_slot, counts, crash, ~crash, vb, vb.copy(), vb.copy()


def _plain(edge_slot, counts, crash, hang, vb, vc, vh):
    us, seg = st.make_static_maps(edge_slot)
    return st.static_triage_plain(*map(torch.from_numpy, (
        vb, vc, vh, counts, us, seg, crash, hang)))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


class _EmuTable:
    """The wrapper's first-of-hash table and scratch, on the host."""

    def __init__(self, b, u):
        sc = st._Scratch(torch.device("cpu"), b, u)
        self.sc = sc
        # junk where the kernels must write before they read
        sc.lane_slot.fill_(-5)
        sc.lane_nov.fill_(0xA5)
        sc.acc.fill_(-1)
        sc.any.fill_(-1)


def _emu_run(emu, table, edge_slot, counts, crash, hang, vb, vc, vh,
             threads=64):
    us, seg = st.make_static_maps(edge_slot)
    us_t, seg_t = torch.from_numpy(us), torch.from_numpy(seg)
    slots, edges = st.slot_table(us_t, seg_t)
    b, row = counts.shape
    u, e = len(us), len(seg)
    sc = table.sc
    outs = (torch.full((b,), -7, dtype=torch.int32),
            torch.full((b,), True), torch.full((b,), True),
            *(torch.full((MAP,), 0x5A, dtype=torch.uint8) for _ in range(3)))
    counts_t, crash_t, hang_t = (torch.from_numpy(a) for a in
                                 (counts, crash, hang))
    maps = [torch.from_numpy(v) for v in (vb, vc, vh)]
    plan = (ctypes.c_int * 2)()
    emu.emu_triage(threads, _p(counts_t), row, b, _p(slots), _p(edges), u,
                   e, _p(us_t), *map(_p, maps), MAP, _p(crash_t),
                   _p(hang_t), _p(sc.keys), _p(sc.mins), sc.cap,
                   sc.next_epoch(), _p(sc.lane_slot), _p(sc.lane_nov),
                   _p(sc.acc), _p(sc.any), *map(_p, outs), plan)
    return outs, (plan[0], plan[1])


def _same(out, ref):
    for o, r in zip(out, ref):
        assert torch.equal(o.to(torch.int64), r.to(torch.int64))


CASES = ["fresh", "seen", "hot_key", "no_active"]


@pytest.mark.parametrize("case", CASES)
def test_triage_kernel_source_matches_plain(case, emu):
    """Two batches through one table (the second under a new epoch,
    over the first's entries), B = 300: not a multiple of the block."""
    rng = np.random.default_rng(40 + CASES.index(case))
    table = _EmuTable(300, 64)
    for _ in range(2):
        args = _scenario(case, rng)
        out, plan = _emu_run(emu, table, *args)
        assert plan == (1, 1)
        _same(out, _plain(*args))
        if case == "no_active":
            assert not any(t.any() for t in out[:3])
            assert all(torch.equal(o, torch.from_numpy(v))
                       for o, v in zip(out[3:], args[4:]))


def test_triage_kernel_source_dedups_hash_collisions(emu):
    args = _collision(np.random.default_rng(2))
    ref = _plain(*args)
    assert ref[0][5] == 2 and ref[0][9] == 0 and ref[1][5] and not ref[1][9]
    out, _ = _emu_run(emu, _EmuTable(100, 8), *args)
    _same(out, ref)


@pytest.mark.parametrize("name", ["tlvstack_vm", "fixedform_vm"])
def test_triage_kernel_source_on_program_shapes(name, emu):
    """The (E, U) of tlvstack_vm and of fixedform_vm (U < E: slots
    that two edges share)."""
    prog = get_target(name)
    rng = np.random.default_rng(len(name))
    args = _scenario("seen", rng, B=130,
                     edge_slot=np.asarray(prog.edge_slot, np.int32))
    out, plan = _emu_run(emu, _EmuTable(130, 600), *args)
    assert plan == (1, 1)
    _same(out, _plain(*args))


@pytest.mark.parametrize("shape", ["table_in_device_memory",
                                   "accumulator_in_device_memory"])
def test_triage_kernel_source_large_tables(shape, emu):
    """Slot tables too large for shared memory: read from device memory
    (and, past 12287 slots, the map accumulator there too)."""
    rng = np.random.default_rng(3)
    u = 2600 if shape == "table_in_device_memory" else 12400
    slots = rng.choice(MAP, u, replace=False).astype(np.int32)
    edge_slot = np.concatenate([slots, rng.choice(slots, 400)])
    args = _scenario("fresh", rng, B=70, edge_slot=edge_slot)
    out, plan = _emu_run(emu, _EmuTable(70, u), *args)
    assert plan == (0, int(shape == "table_in_device_memory"))
    _same(out, _plain(*args))


# --------------------------------------------------------------------
# the wrapper's CPU side
# --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tlvstack_vm", "fixedform_vm", "test",
                                  "collisions"])
def test_slot_table_reproduces_the_slot_fold(name):
    """Summing each slot's CSR edges gives ``counts_by_slot``."""
    rng = np.random.default_rng(11)
    if name == "collisions":
        edge_slot = rng.integers(0, 30, 200).astype(np.int32)
    else:
        edge_slot = np.asarray(get_target(name).edge_slot, np.int32)
    us, seg = st.make_static_maps(edge_slot)
    slots, edges = st.slot_table(torch.from_numpy(us), torch.from_numpy(seg))
    assert slots.shape == (len(us), 4) and edges.shape == (len(seg),)
    assert torch.equal(slots[:, 2], torch.from_numpy(us))
    assert torch.equal(torch.sort(edges.long()).values,
                       torch.arange(len(seg)))
    counts = torch.from_numpy(
        rng.integers(0, 256, (50, len(seg) + 1)).astype(np.uint8))
    fold = torch.zeros((50, len(us)), dtype=torch.int32)
    for s, (lo, hi, _, _) in enumerate(slots.tolist()):
        for e in edges[lo:hi].tolist():
            assert seg[e] == s
            fold[:, s] += counts[:, e].to(torch.int32)
    assert torch.equal((fold & 0xFF).to(torch.uint8), st.counts_by_slot(
        counts, torch.from_numpy(seg), len(us)))


@pytest.mark.parametrize("case", CASES)
def test_cpu_tensors_take_the_plain_version(case):
    rng = np.random.default_rng(50 + CASES.index(case))
    edge_slot, counts, crash, hang, vb, vc, vh = _scenario(case, rng)
    us, seg = st.make_static_maps(edge_slot)
    before = vk.LAUNCHES["kbz_triage"]
    args = [torch.from_numpy(a) for a in (vb, vc, vh, counts, us, seg,
                                          crash, hang)]
    _same(st.static_triage(*args), st.static_triage_plain(*args))
    assert vk.LAUNCHES["kbz_triage"] == before
    if not torch.cuda.is_available():
        assert before == 0


@pytest.mark.parametrize("t", [1, 5, 32, 186, 506])
def test_column_hash_is_one_xor(t):
    """The kernels' hash, one XOR of fmix32(cls ^ j * 0x9E3779B9) over
    the columns, equals ``stream_hash``'s half-folding."""
    rng = np.random.default_rng(t)
    words = rng.integers(0, 256, (64, t)).astype(np.uint64)
    x = (words ^ ((np.arange(t, dtype=np.uint64) * 0x9E3779B9)
                  & 0xFFFFFFFF)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    ref = np.bitwise_xor.reduce(x, axis=1)
    got = sparse_coverage.stream_hash(torch.from_numpy(words.astype(
        np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint64), ref)


# --------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card(args, cuda):
    edge_slot, counts, crash, hang, vb, vc, vh = args
    us, seg = st.make_static_maps(edge_slot)
    return st.static_triage(*(torch.from_numpy(a).to(cuda) for a in (
        vb, vc, vh, counts, us, seg, crash, hang)))


def _same_card(out, ref):
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu().to(torch.int64), r.to(torch.int64))


@pytest.mark.device
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("B", [300, 4096, 65536 + 77])
def test_triage_kernels_match_plain(case, B, cuda):
    rng = np.random.default_rng(B + CASES.index(case))
    before = vk.LAUNCHES["kbz_triage"]
    for _ in range(3):                  # one table, new epochs
        args = _scenario(case, rng, B=B)
        _same_card(_card(args, cuda), _plain(*args))
    torch.cuda.synchronize()
    assert vk.LAUNCHES["kbz_triage"] == before + 3


@pytest.mark.device
@pytest.mark.parametrize("name", ["tlvstack_vm", "fixedform_vm",
                                  "table_in_device_memory",
                                  "accumulator_in_device_memory"])
def test_triage_kernels_on_program_shapes(name, cuda):
    rng = np.random.default_rng(7)
    if name in ("tlvstack_vm", "fixedform_vm"):
        edge_slot = np.asarray(get_target(name).edge_slot, np.int32)
    else:
        u = 2600 if name == "table_in_device_memory" else 12400
        slots = rng.choice(MAP, u, replace=False).astype(np.int32)
        edge_slot = np.concatenate([slots, rng.choice(slots, 400)])
    for case in ("fresh", "seen", "hot_key"):
        args = _scenario(case, rng, B=8192 + 5, edge_slot=edge_slot)
        _same_card(_card(args, cuda), _plain(*args))


@pytest.mark.device
def test_triage_kernels_dedup_hash_collisions(cuda):
    args = _collision(np.random.default_rng(2))
    _same_card(_card(args, cuda), _plain(*args))


@pytest.mark.device
def test_triage_kernels_never_wait_for_the_card(cuda):
    """After the first call (which builds the program's slot table),
    a triage on the card reads nothing back to the host."""
    rng = np.random.default_rng(1)
    edge_slot, counts, crash, hang, vb, vc, vh = _scenario("seen", rng,
                                                           B=4096)
    us, seg = st.make_static_maps(edge_slot)
    args = [torch.from_numpy(a).to(cuda) for a in (vb, vc, vh, counts, us,
                                                   seg, crash, hang)]
    st.static_triage(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = st.static_triage(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same_card(out, st.static_triage_plain(*(a.cpu() for a in args)))
