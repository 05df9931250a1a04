// Throughput triage for Hopper (sm_90a): static_triage of
// ops/static_triage.py as three kernels, written by hand in CUDA C++.
//
// What they replace: no pallas_call.  The JAX package leaves its
// ops/static_triage.py to XLA, which fuses the chain on the TPU; in
// PyTorch the same chain is ~250 separate operations a batch (the slot
// fold's index_add, the class gather, the hash's int64 passes, the
// first-occurrence sort and the eight bit-plane max-reductions of the
// map update), each a trip through device memory and a launch the host
// pays for.
//
// Semantics, as static_triage_plain computes them, bit for bit:
//   by_slot[s] = (sum of counts[e] over seg_id[e] == s) & 0xFF, the
//   overflow column dropped; cls = COUNT_CLASS_LOOKUP[by_slot], simp =
//   by_slot ? 128 : 1; a lane's novelty against a map v (read at
//   u_slots) is 2 if some cls_s != 0 with v_s == 0xFF, else 1 if some
//   cls_s & v_s, else 0 (vb with cls; vc and vh with simp); its dedup
//   hash is XOR_s fmix32(cls_s ^ s * 0x9E3779B9) over all U slots
//   (stream_hash's half-folding is one XOR); a lane keeps its verdict
//   if it is the lowest lane with its hash (overall, among crash lanes,
//   among hang lanes); each map loses the OR of its active lanes'
//   class bits at u_slots, vc and vh also bit 0 everywhere else, and a
//   map with no active lane comes back as it was.
//
// What bounds them (chip_smoke.py phase 17 sets the time beside it):
// the operations of the fold, the classes, the three novelty tests and
// the hash (benchmark/kbbench/arith.triage_ops), and the bytes of the
// counts, read once (B * (E + 1)).  The design keeps every
// intermediate out of device memory but one int32 and one byte a lane:
//   * kbz_triage_lanes: one warp per lane at a time.  Thread t of the
//     warp takes slots t, t + 32, ...: it sums the slot's edges through
//     a slot -> edges table (CSR, built once per program by the
//     wrapper), classifies, tests the three virgin bytes and adds its
//     hash terms; the warp reduces the hash by XOR and the novelty
//     bits by OR (one REDUX each).  A warp judges 32 consecutive lanes
//     and then holds one lane per thread for the first-of-hash table:
//     lanes with equal hashes group with __match_any_sync, so each
//     distinct hash of the 32 costs one probe of the table and one
//     atomicMin per kind (all, crash, hang), whose lowest thread is
//     the lowest lane.  A saturated corpus puts most lanes on a few
//     hashes: the atomics on such a key fall 32-fold, and a min that
//     is already lower is read and left alone.  The slot table with
//     the batch's three virgin bytes and the edge list are staged in
//     shared memory when they fit TRIAGE_STAGE_MAX, else read from
//     device memory (a template on where they live).
//   * The table: open addressing over a power of two of at least 2B
//     entries, a 64-bit key (epoch << 32 | hash) and three 64-bit
//     mins (~epoch << 32 | lane).  The wrapper gives each batch a new
//     epoch, so an entry of an older batch reads as empty and loses
//     every atomicMin: nothing is cleared between batches.
//   * kbz_triage_resolve: one thread per lane reads its entry, writes
//     rets, uc and uh, and the warp walks its active lanes (few, once a
//     corpus saturates), recomputing each one's classes from the
//     counts and ORing them into a block accumulator in shared memory
//     (U words: cls | simp << 8 | simp << 16), one global atomicOr per
//     word a block; with the "any active lane" bits.
//   * kbz_triage_maps: one block copies the three maps into the fresh
//     outputs, clearing bit 0 of vc and vh where a crash (hang) lane
//     was active, then, after a barrier, writes the U slots cleared by
//     the accumulator.
// Three launches a batch, no host sync; the accumulator and the "any"
// bits are zeroed by kbz_triage_lanes' first block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TRIAGE_THREADS = 256;       // lanes and resolve blocks
constexpr int TRIAGE_MAPS_THREADS = 1024;
// the most shared memory a block takes for the staged slot table and
// edge list, or for the resolve accumulator; larger ones stay in
// device memory (no opt-in attribute needed below 48 KB)
constexpr int TRIAGE_STAGE_MAX = 48 * 1024;

struct TriagePlan {
  int lanes_grid, staged, stage_bytes;     // kbz_triage_lanes
  int resolve_grid, acc_shared, acc_bytes; // kbz_triage_resolve
};

__host__ __device__ inline TriagePlan triage_plan(int B, int U, int E,
                                                  int threads) {
  TriagePlan p;
  const int blocks = (B + threads - 1) / threads;
  p.lanes_grid = blocks > 0 ? blocks : 1;
  p.stage_bytes = 16 * U + 4 * E;
  p.staged = p.stage_bytes <= TRIAGE_STAGE_MAX;
  if (!p.staged) p.stage_bytes = 0;
  // the block's "any active lane" word, then the accumulator if it fits
  p.resolve_grid = p.lanes_grid;
  p.acc_shared = 4 * U + 4 <= TRIAGE_STAGE_MAX;
  p.acc_bytes = p.acc_shared ? 4 * U + 4 : 4;
  return p;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// COUNT_CLASS_LOOKUP without a table: 0, 1, 2 -> themselves, 3 -> 4,
// else by the top bit m (2..7) -> 8, 16, 32, 64, 64, 128
__device__ __forceinline__ uint32_t count_class(uint32_t c) {
  const uint32_t lo = (0x04020100u >> (8u * (c & 3u))) & 0xFFu;
  const uint32_t m = 31u - (uint32_t)__clz((int)(c | 1u));
  const uint32_t hi =
      (uint32_t)(0x8040402010080000ull >> (8u * m)) & 0xFFu;
  return c < 4u ? lo : hi;
}

// AFL's ret code from a map's two novelty bits (new tuple, new count)
__device__ __forceinline__ uint32_t ret_code(uint32_t fl, int at) {
  return (fl >> at) & 1u ? 2u : ((fl >> (at + 1)) & 1u);
}

struct LaneArgs {
  const uint8_t* counts;
  long long row;                // E + 1
  int B, U, E;
  const int4* slots;            // [U] {edge begin, edge end, u_slot, 0}
  const int* edges;             // [E] edge ids grouped by slot
  const uint8_t* vb;
  const uint8_t* vc;
  const uint8_t* vh;
  const uint8_t* crash;
  const uint8_t* hang;
  unsigned long long* keys;     // [cap]
  unsigned long long* mins;     // [3][cap]
  unsigned cap;                 // a power of two
  unsigned epoch;
  int* lane_slot;               // [B] the lane's table entry
  uint8_t* lane_nov;            // [B] rb | rc << 2 | rh << 4 | crash << 6
                                //     | hang << 7
  unsigned* gacc;               // [U]
  unsigned* gany;               // [1]
};

// One lane judged by the whole warp: its hash and the six novelty bits
// (new tuple, new count) of vb, vc and vh, as every thread's result.
template <bool STAGED>
__device__ __forceinline__ void judge_lane(const LaneArgs& a,
                                           const uint4* stab,
                                           const int* sedges,
                                           const uint8_t* row, int lid,
                                           uint32_t& h, uint32_t& fl) {
  h = 0u;
  fl = 0u;
  for (int s = lid; s < a.U; s += 32) {
    int eb, ee;
    uint32_t vp;
    if (STAGED) {
      const uint4 t = stab[s];
      eb = (int)t.x;
      ee = (int)t.y;
      vp = t.z;
    } else {
      const int4 t = __ldg(a.slots + s);
      eb = t.x;
      ee = t.y;
      vp = (uint32_t)__ldg(a.vb + t.z) | ((uint32_t)__ldg(a.vc + t.z) << 8)
           | ((uint32_t)__ldg(a.vh + t.z) << 16);
    }
    uint32_t sum = 0u;
    for (int e = eb; e < ee; ++e)
      sum += __ldg(row + (STAGED ? sedges[e] : __ldg(a.edges + e)));
    const uint32_t c = sum & 0xFFu;
    const uint32_t cl = count_class(c);
    const uint32_t sp = c ? 128u : 1u;
    const uint32_t b = vp & 0xFFu, cv = (vp >> 8) & 0xFFu,
                   hv = (vp >> 16) & 0xFFu;
    fl |= (cl != 0u && b == 0xFFu ? 1u : 0u) | ((cl & b) ? 2u : 0u)
          | (cv == 0xFFu ? 4u : 0u) | ((sp & cv) ? 8u : 0u)
          | (hv == 0xFFu ? 16u : 0u) | ((sp & hv) ? 32u : 0u);
    h ^= fmix32(cl ^ ((uint32_t)s * 0x9E3779B9u));
  }
  h = __reduce_xor_sync(FULL, h);
  fl = __reduce_or_sync(FULL, fl);
}

// The entry of hash h in this epoch's table, claimed if it has none.
__device__ __forceinline__ unsigned table_entry(unsigned long long* keys,
                                                unsigned cap,
                                                unsigned epoch, uint32_t h) {
  const unsigned long long want =
      ((unsigned long long)epoch << 32) | (unsigned long long)h;
  unsigned i = h & (cap - 1u);
  for (;;) {
    const unsigned long long k = __ldcg(keys + i);
    if (k == want) return i;
    if ((unsigned)(k >> 32) != epoch) {        // an older batch's: free
      const unsigned long long old = atomicCAS(keys + i, k, want);
      if (old == k || old == want) return i;
    }
    i = (i + 1u) & (cap - 1u);
  }
}

__device__ __forceinline__ void min_into(unsigned long long* p,
                                         unsigned long long v) {
  if (__ldcg(p) > v) atomicMin(p, v);
}

template <bool STAGED>
__global__ void __launch_bounds__(TRIAGE_THREADS)
kbz_triage_lanes(LaneArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stab = reinterpret_cast<uint4*>(smem);
  int* sedges = reinterpret_cast<int*>(smem + 16 * a.U);
  const int tid = threadIdx.x;
  if (STAGED) {
    for (int s = tid; s < a.U; s += blockDim.x) {
      const int4 t = a.slots[s];
      stab[s] = make_uint4((unsigned)t.x, (unsigned)t.y,
                           (uint32_t)a.vb[t.z] | ((uint32_t)a.vc[t.z] << 8)
                               | ((uint32_t)a.vh[t.z] << 16), 0u);
    }
    for (int e = tid; e < a.E; e += blockDim.x) sedges[e] = a.edges[e];
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int s = tid; s < a.U; s += blockDim.x) a.gacc[s] = 0u;
    if (tid == 0) *a.gany = 0u;
  }
  const int lid = tid & 31;
  const int warps = blockDim.x >> 5;
  const long long n_chunks = ((long long)a.B + 31) >> 5;
  const unsigned long long tag = (unsigned long long)(~a.epoch) << 32;
  for (long long chunk = (long long)blockIdx.x * warps + (tid >> 5);
       chunk < n_chunks; chunk += (long long)gridDim.x * warps) {
    const long long base = chunk << 5;
    const long long left = (long long)a.B - base;
    const int n = left < 32 ? (int)left : 32;
    uint32_t my_h = 0u, my_fl = 0u;
    for (int i = 0; i < n; ++i) {
      uint32_t h, fl;
      judge_lane<STAGED>(a, stab, sedges, a.counts + (base + i) * a.row,
                         lid, h, fl);
      if (lid == i) {
        my_h = h;
        my_fl = fl;
      }
    }
    const bool valid = lid < n;
    const long long lane = base + lid;
    const bool cr = valid && a.crash[lane] != 0;
    const bool hg = valid && a.hang[lane] != 0;
    // the lanes of this chunk with my hash, the lowest one leading
    const unsigned act = __ballot_sync(FULL, valid);
    const unsigned peers = __match_any_sync(FULL, my_h) & act;
    const unsigned cmask = __ballot_sync(FULL, cr);
    const unsigned hmask = __ballot_sync(FULL, hg);
    const int leader = valid ? __ffs(peers) - 1 : lid;
    int entry = 0;
    if (valid && lid == leader) entry = table_entry(a.keys, a.cap, a.epoch,
                                                    my_h);
    entry = __shfl_sync(FULL, entry, leader);
    if (valid) {
      const unsigned long long me = tag | (unsigned long long)lane;
      if (lid == leader) min_into(a.mins + entry, me);
      if (cr && lid == __ffs(peers & cmask) - 1)
        min_into(a.mins + a.cap + entry, me);
      if (hg && lid == __ffs(peers & hmask) - 1)
        min_into(a.mins + 2ull * a.cap + entry, me);
      a.lane_slot[lane] = entry;
      a.lane_nov[lane] = (uint8_t)(ret_code(my_fl, 0)
                                   | (ret_code(my_fl, 2) << 2)
                                   | (ret_code(my_fl, 4) << 4)
                                   | ((unsigned)cr << 6)
                                   | ((unsigned)hg << 7));
    }
  }
}

struct ResolveArgs {
  const uint8_t* counts;
  long long row;
  int B, U;
  const int4* slots;
  const int* edges;
  const unsigned long long* mins;
  unsigned cap, epoch;
  const int* lane_slot;
  const uint8_t* lane_nov;
  int* rets;
  uint8_t* uc;
  uint8_t* uh;
  unsigned* gacc;
  unsigned* gany;
  int acc_shared;
};

__global__ void __launch_bounds__(TRIAGE_THREADS)
kbz_triage_resolve(ResolveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned& s_any = *reinterpret_cast<unsigned*>(smem);
  unsigned* acc = a.acc_shared ? reinterpret_cast<unsigned*>(smem) + 1
                               : a.gacc;
  const int tid = threadIdx.x;
  if (a.acc_shared)
    for (int s = tid; s < a.U; s += blockDim.x) acc[s] = 0u;
  if (tid == 0) s_any = 0u;
  __syncthreads();
  const int lid = tid & 31;
  const int warps = blockDim.x >> 5;
  const long long n_chunks = ((long long)a.B + 31) >> 5;
  const unsigned long long tag = (unsigned long long)(~a.epoch) << 32;
  for (long long chunk = (long long)blockIdx.x * warps + (tid >> 5);
       chunk < n_chunks; chunk += (long long)gridDim.x * warps) {
    const long long base = chunk << 5;
    const long long lane = base + lid;
    uint32_t r = 0u;
    bool c = false, h = false;
    if (lane < a.B) {
      const int e = a.lane_slot[lane];
      const uint32_t nov = a.lane_nov[lane];
      const unsigned long long me = tag | (unsigned long long)lane;
      if (a.mins[e] == me) r = nov & 3u;
      c = ((nov >> 6) & 1u) && ((nov >> 2) & 3u)
          && a.mins[a.cap + e] == me;
      h = ((nov >> 7) & 1u) && ((nov >> 4) & 3u)
          && a.mins[2ull * a.cap + e] == me;
      a.rets[lane] = (int)r;
      a.uc[lane] = c;
      a.uh[lane] = h;
    }
    const unsigned wb = __ballot_sync(FULL, r != 0u);
    const unsigned wc = __ballot_sync(FULL, c);
    const unsigned wh = __ballot_sync(FULL, h);
    unsigned todo = wb | wc | wh;
    if (lid == 0 && todo)
      atomicOr(&s_any, (wb ? 1u : 0u) | (wc ? 2u : 0u) | (wh ? 4u : 0u));
    while (todo) {                 // the chunk's active lanes, in turn
      const int i = __ffs(todo) - 1;
      todo &= todo - 1u;
      const uint8_t* row = a.counts + (base + i) * a.row;
      const bool ob = (wb >> i) & 1u, oc = (wc >> i) & 1u,
                 oh = (wh >> i) & 1u;
      for (int s = lid; s < a.U; s += 32) {
        const int4 t = __ldg(a.slots + s);
        uint32_t sum = 0u;
        for (int e = t.x; e < t.y; ++e) sum += __ldg(row + __ldg(a.edges + e));
        const uint32_t cnt = sum & 0xFFu;
        const uint32_t sp = cnt ? 128u : 1u;
        const uint32_t bits = (ob ? count_class(cnt) : 0u)
                              | (oc ? sp << 8 : 0u) | (oh ? sp << 16 : 0u);
        if (bits) atomicOr(acc + s, bits);
      }
    }
  }
  __syncthreads();
  if (a.acc_shared)
    for (int s = tid; s < a.U; s += blockDim.x)
      if (acc[s]) atomicOr(a.gacc + s, acc[s]);
  if (tid == 0 && s_any) atomicOr(a.gany, s_any);
}

struct MapsArgs {
  const uint8_t* vb;
  const uint8_t* vc;
  const uint8_t* vh;
  int words;                    // map bytes / 4
  const int* u_slots;
  int U;
  const unsigned* gacc;
  const unsigned* gany;
  uint8_t* ob;
  uint8_t* oc;
  uint8_t* oh;
};

__global__ void __launch_bounds__(TRIAGE_MAPS_THREADS)
kbz_triage_maps(MapsArgs a) {
  const unsigned any = *a.gany;
  const uint32_t mc = (any & 2u) ? 0xFEFEFEFEu : FULL;
  const uint32_t mh = (any & 4u) ? 0xFEFEFEFEu : FULL;
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(a.vb);
  const uint32_t* vc = reinterpret_cast<const uint32_t*>(a.vc);
  const uint32_t* vh = reinterpret_cast<const uint32_t*>(a.vh);
  uint32_t* ob = reinterpret_cast<uint32_t*>(a.ob);
  uint32_t* oc = reinterpret_cast<uint32_t*>(a.oc);
  uint32_t* oh = reinterpret_cast<uint32_t*>(a.oh);
  for (int w = threadIdx.x; w < a.words; w += blockDim.x) {
    ob[w] = vb[w];
    oc[w] = vc[w] & mc;
    oh[w] = vh[w] & mh;
  }
  __syncthreads();
  // an inactive map's accumulator bits are 0: its slots stay as they were
  for (int s = threadIdx.x; s < a.U; s += blockDim.x) {
    const int u = a.u_slots[s];
    const uint32_t m = a.gacc[s];
    a.ob[u] = (uint8_t)(a.vb[u] & ~m);
    a.oc[u] = (uint8_t)(a.vc[u] & ~(m >> 8));
    a.oh[u] = (uint8_t)(a.vh[u] & ~(m >> 16));
  }
}

}  // namespace

// ---- host launch code

extern "C" int kbz_triage_launch(
    const void* counts, int row, int B, const void* slots,
    const void* edges, int U, int E, const void* u_slots, const void* vb,
    const void* vc, const void* vh, int map_bytes, const void* crash,
    const void* hang, void* keys, void* mins, unsigned cap, unsigned epoch,
    void* lane_slot, void* lane_nov, void* gacc, void* gany, void* rets,
    void* uc, void* uh, void* ob, void* oc, void* oh, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const TriagePlan p = triage_plan(B, U, E, TRIAGE_THREADS);
  LaneArgs la{(const uint8_t*)counts, row, B, U, E, (const int4*)slots,
              (const int*)edges, (const uint8_t*)vb, (const uint8_t*)vc,
              (const uint8_t*)vh, (const uint8_t*)crash,
              (const uint8_t*)hang, (unsigned long long*)keys,
              (unsigned long long*)mins, cap, epoch, (int*)lane_slot,
              (uint8_t*)lane_nov, (unsigned*)gacc, (unsigned*)gany};
  if (p.staged)
    kbz_triage_lanes<true><<<p.lanes_grid, TRIAGE_THREADS, p.stage_bytes,
                             st>>>(la);
  else
    kbz_triage_lanes<false><<<p.lanes_grid, TRIAGE_THREADS, 0, st>>>(la);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ResolveArgs ra{(const uint8_t*)counts, row, B, U, (const int4*)slots,
                 (const int*)edges, (const unsigned long long*)mins, cap,
                 epoch, (const int*)lane_slot, (const uint8_t*)lane_nov,
                 (int*)rets, (uint8_t*)uc, (uint8_t*)uh, (unsigned*)gacc,
                 (unsigned*)gany, p.acc_shared};
  kbz_triage_resolve<<<p.resolve_grid, TRIAGE_THREADS, p.acc_bytes, st>>>(
      ra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  MapsArgs ma{(const uint8_t*)vb, (const uint8_t*)vc, (const uint8_t*)vh,
              map_bytes / 4, (const int*)u_slots, U, (const unsigned*)gacc,
              (const unsigned*)gany, (uint8_t*)ob, (uint8_t*)oc,
              (uint8_t*)oh};
  kbz_triage_maps<<<1, TRIAGE_MAPS_THREADS, 0, st>>>(ma);
  return (int)cudaGetLastError();
}

