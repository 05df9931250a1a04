// KBVM kernels for Hopper (sm_90a): the fused havoc + VM kernel and
// the VM kernel, written by hand in CUDA C++.
//
// What they replace (killerbeez_tpu/ops/vm_kernel.py, Pallas on TPU):
//   kbz_fuzz_kernel  <- _fuzz_kernel (reached by fuzz_batch_pallas):
//                       per-lane havoc words, the havoc prologue
//                       (_havoc_edit) and the VM loop (_vm_loop)
//   kbz_vm_kernel    <- _vm_kernel_skip (run_batch_pallas(skip=...)) and
//                       _vm_kernel (run_batch_pallas(skip=None)): the VM
//                       loop over given inputs, optionally over a list
//                       of lanes (phase 2 of two-phase scheduling)
//
// Semantics mirror killerbeez_tpu/models/vm._step_batched line by line
// (the Pallas kernels are held bit-identical to it): int32 arithmetic
// wraps (computed in uint32), shift counts clip to 0..31, SHR is
// logical, compares are signed; the instruction at the CLIPPED pc runs
// in the step where pc leaves the program (its register write, store,
// edge count and hash update included) and that step then crashes,
// crash taking precedence over halt; exit_code is set by HALT while
// running; counts wrap at u8.  The havoc prologue mirrors
// ops/mutate_core._havoc_one: delete, insert and overwrite read the
// whole PRE-edit buffer, so they write a second per-lane buffer (ping
// pong); the other eleven ops change at most 4 bytes and edit in place.
// The havoc words are jax.random's: lane i's key is fold_in(base_key,
// its[i]) and its word j is x0 ^ x1 of threefry2x32(key, (0, j))
// (ops/prng.py), computed here for just the words the lane uses.
// The seed is row *sel of a ring of seeds u8[S][L] and its length
// lens[*sel], both read on the device: the device-resident generation
// loop (ops/generations.py) picks the slot on the card, so no host
// round trip sits between two generations; a single seed is a ring of
// one slot with *sel = 0.
//
// What bounds them on this card (chip_smoke.py counts the bytes and
// the operations each run's data needs): kbz_fuzz_kernel is bound by
// operations, most of them the threefry hashes (~80 int32 operations
// each, 1 + 1 + 8 * stack per lane); kbz_vm_kernel over the phase-2
// survivors is bound by operations too (~13 per VM step).  Both run
// far from that bound, held by what the roofline does not see: lanes
// of a warp diverge (a warp runs until its longest lane stops, taking
// every branch any lane takes) and each VM step is a chain of
// dependent loads (instruction, registers, edge table, count).
//
// The design: one thread per lane, and all a VM step touches but its
// scratch cells in shared memory, so that those loads in the chain are
// shared-memory loads and not trips to L1/L2:
//   * the instruction table (int4[NI]) and the edge table, narrowed by
//     the wrapper to u8 (n_edges < 256) or u16, are staged once per
//     block.  A table that does not fit (the cap is TABLE_SMEM_MAX in
//     ops/vm_kernel.py; fixedform_vm's 343 x 342 is 235 KB even as
//     u16) is read from device memory through __ldg instead: the
//     kernels are templates on the table's type (and on where the lane
//     state lives, below), one instance each;
//   * per-lane state in lane-minor 32-bit words ([k][blockDim]), so
//     the 32 lanes of a warp touching "their" word k hit 32 distinct
//     banks whatever k each lane uses: the eight VM registers (kept in
//     shared memory: nvcc 12.9 at -O3 miscompiled a select chain that
//     kept them in registers, reading the wrong register, and the
//     register-stress test program of tests/test_torch_cuda_source.py
//     guards against any such change) and the candidate buffers (byte
//     i of a lane in word i / 4, byte i % 4);
//   * the u8 edge counts as the block's rows of the output, [blockDim]
//     [n_edges + 1] bytes, zeroed in shared memory and written out as
//     one contiguous copy at the end (kbz_fuzz_kernel), or row by row
//     (kbz_vm_kernel, whose lanes are scattered);
//   * the VM's scratch cells in a lane-minor device-memory array
//     [mem_size][cols] (the wrapper's scratch): in shared memory they
//     halved the fused kernel's resident blocks, and the card measured
//     that slower (PERF.md).
// A lane's buffers and counts row grow with the input length L and the
// edge count.  When a block of STATE_MIN_THREADS threads cannot hold
// them beside the tables within the card's 227 KB per block (with
// tlvstack_vm's tables: L above 712 in the fused kernel, above about
// 1430 in the VM kernel, or 1394 edges and more at L = 64), they live
// in device memory instead, the plan chosen from these sizes
// (lane_state_shared): the buffers as lane-minor rows of the scratch
// array after the cells, the counts straight in the lane's output row
// (the wrapper zeroes it), the seed read from device memory.  Only the
// registers and the tables stay in shared memory, which then always
// fits (each table is capped).
// Shared memory per block (tlvstack_vm: NI 558, 111 x 110 u8 table,
// n_edges 186, mem_size 72, L 64): 8928 B instructions + 12224 B table
// + 64 B seed, then per lane 32 B registers + 187 B counts + 2 x 64 B
// buffers (kbz_vm_kernel: 1 x 64, no seed).  kbz_fuzz_kernel at 256
// threads: 21216 + 256 x 347 = 110048 B (107.5 KB), two blocks per SM
// (the SM has 228 KB; each block also reserves 1 KB).
// The launch functions take the block size (256, 128, 64 or 32) that
// keeps the most threads resident per SM (cudaOccupancy...), raise the
// block's dynamic shared memory limit above 48 KB with
// cudaFuncSetAttribute, and return cudaGetLastError().
//
// kbz_fuzz_kernel, and kbz_vm_kernel without a lane list: block b owns
// lanes [b * blockDim, ...), so its counts are one contiguous range of
// the output, written as one coalesced copy.  kbz_vm_kernel with a lane
// list (phase 2) is persistent: it launches at most as many blocks as
// fit on the card at once, and spreads the listed lanes over every
// block and every warp (slot s goes to block s % grid, then to the
// warps of that block, then to their threads), so a short list (~12.5K
// survivors at B = 65536) keeps every SM and every warp scheduler busy
// with warps of few lanes, which diverge less; a thread whose lane
// stops takes slot s + grid * blockDim.  Phase 2 passes its lane list
// and its length as device pointers, so no host sync is needed to
// launch it.
//
// A VM step is a switch on the op, as the plain version reads; the
// shared-memory loads a step may need (its registers, the input byte)
// are issued before the dispatch so that their latencies overlap.  A
// fully branch-free step (every load issued, the op selecting among
// the results) measured slower on the card: its unconditional load of
// a scratch cell waits on device memory every step.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FUZZ_NONE = 0;
constexpr int FUZZ_CRASH = 2;
constexpr int FUZZ_RUNNING = 3;
constexpr int MAP_SIZE = 1 << 16;
constexpr uint32_t THREEFRY_PARITY = 0x1BD11BDAu;

enum : int {
  OP_HALT = 0, OP_BLOCK = 1, OP_LDB = 2, OP_LDI = 3, OP_ALU = 4,
  OP_ADDI = 5, OP_JMP = 6, OP_BR = 7, OP_CRASH = 8, OP_LEN = 9,
  OP_LDM = 10, OP_STM = 11,
};

// where the edge table is read from (the wrapper's table_mode)
enum : int { TABLE_DEVICE = 0, TABLE_U8 = 1, TABLE_U16 = 2 };

__constant__ uint32_t kInteresting8[9] = {
    0x80u, 0xFFu, 0u, 1u, 16u, 32u, 64u, 100u, 127u};
__constant__ uint32_t kInteresting16[10] = {
    0x8000u, 0xFF7Fu, 128u, 255u, 256u, 512u, 1000u, 1024u, 4096u,
    32767u};
__constant__ uint32_t kInteresting32[8] = {
    0x80000000u, 0xFA0000FAu, 0xFFFF7FFFu, 32768u, 65535u, 65536u,
    100663045u, 2147483647u};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// ---- threefry-2x32, bit-identical to jax.random (ops/prng.py) -------

__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1,
                                             int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// The Threefry-2x32 hash (20 rounds) of counters (x0, x1) under key
// (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ THREEFRY_PARITY};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      threefry_mix(x0, x1, 13);
      threefry_mix(x0, x1, 15);
      threefry_mix(x0, x1, 26);
      threefry_mix(x0, x1, 6);
    } else {
      threefry_mix(x0, x1, 17);
      threefry_mix(x0, x1, 29);
      threefry_mix(x0, x1, 16);
      threefry_mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.bits(key, ...) word j (j < 2**32): x0 ^ x1 of the hash of
// the counter (0, j).
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.fold_in(key, d): the key (x0, x1) hashed from (0, d).
__device__ __forceinline__ void threefry_fold_in(uint32_t k0, uint32_t k1,
                                                 uint32_t d, uint32_t& o0,
                                                 uint32_t& o1) {
  o0 = 0u;
  o1 = d;
  threefry2x32(k0, k1, o0, o1);
}

// ---- shared-memory layout -------------------------------------------

// Byte offsets into a block's dynamic shared memory; -1 where the
// array lives in device memory instead.  Lane-minor arrays hold word k
// of thread t at [k * threads + t].
struct Plan {
  int threads;  // blockDim.x
  int instrs;   // int4[ni]
  int table;    // u8 / u16 [(nb + 1) * nb]
  int seed;     // u32[words]: the seed, packed (kbz_fuzz_kernel)
  int regs;     // int32[8][threads]
  int counts;   // u8[threads][n_edges + 1]
  int buf0;     // u32[words][threads]
  int buf1;     // u32[words][threads] (kbz_fuzz_kernel)
  int bytes;    // total
};

// The least block size whose lanes' buffers and counts rows must fit
// in shared memory for them to live there: four warps, one for each
// of the SM's schedulers.
constexpr int STATE_MIN_THREADS = 128;

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// The block's layout.  `state_shared` 0 leaves the seed, the buffers
// and the counts rows in device memory.
__host__ __device__ inline Plan make_plan(int threads, int ni,
                                          int instrs_shared, int nb,
                                          int table_mode, int state_shared,
                                          int n_edges, int L, int fuzz) {
  const int words = (L + 3) / 4;
  const bool st = state_shared != 0;
  Plan p;
  int off = 0;
  p.threads = threads;
  p.instrs = instrs_shared ? off : -1;
  off += instrs_shared ? align16(ni * 16) : 0;
  const int tab_bytes = table_mode == TABLE_U8 ? 1 : 2;
  p.table = table_mode != TABLE_DEVICE ? off : -1;
  off += table_mode != TABLE_DEVICE ? align16((nb + 1) * nb * tab_bytes)
                                    : 0;
  p.seed = st && fuzz ? off : -1;
  off += st && fuzz ? align16(words * 4) : 0;
  p.regs = off;
  off += align16(8 * 4 * threads);
  p.counts = st ? off : -1;
  off += st ? align16((n_edges + 1) * threads) : 0;
  p.buf0 = st ? off : -1;
  off += st ? align16(words * 4 * threads) : 0;
  p.buf1 = st && fuzz ? off : -1;
  off += st && fuzz ? align16(words * 4 * threads) : 0;
  p.bytes = off;
  return p;
}

// Whether the lanes' buffers and counts rows live in shared memory:
// when a block of STATE_MIN_THREADS holds them (and the tables) within
// `smem_max` bytes.
__host__ __device__ inline bool lane_state_shared(int smem_max, int ni,
                                                  int instrs_shared, int nb,
                                                  int table_mode,
                                                  int n_edges, int L,
                                                  int fuzz) {
  return make_plan(STATE_MIN_THREADS, ni, instrs_shared, nb, table_mode, 1,
                   n_edges, L, fuzz).bytes <= smem_max;
}

// kbz_vm_kernel's grid: a block per blockDim lanes, but with a lane
// list no more blocks than are resident at once (the grid is then
// persistent).
__host__ __device__ inline int vm_grid(int n_threads, int threads,
                                       int resident, bool listed) {
  const int needed = (n_threads + threads - 1) / threads;
  return listed && resident < needed ? resident : needed;
}

// Block-wide copy of n bytes, 16 at a time when both ends allow it.
__device__ __forceinline__ void block_copy(void* dst, const void* src,
                                           int n, int tid, int T) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    const int n16 = n / 16;
    const int4* s = static_cast<const int4*>(src);
    int4* d = static_cast<int4*>(dst);
    for (int i = tid; i < n16; i += T) d[i] = s[i];
    done = n16 * 16;
  } else if (((reinterpret_cast<uintptr_t>(dst) |
               reinterpret_cast<uintptr_t>(src)) & 3u) == 0) {
    const int n4 = n / 4;
    const uint32_t* s = static_cast<const uint32_t*>(src);
    uint32_t* d = static_cast<uint32_t*>(dst);
    for (int i = tid; i < n4; i += T) d[i] = s[i];
    done = n4 * 4;
  }
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  for (int i = done + tid; i < n; i += T) d[i] = s[i];
}

// byte i of a lane's buffer (its column of a lane-minor u32 array,
// words S apart)
__device__ __forceinline__ uint8_t* buf_byte(uint32_t* col, int S, int i) {
  return reinterpret_cast<uint8_t*>(col + (i >> 2) * S) + (i & 3);
}
__device__ __forceinline__ uint32_t buf_get(const uint32_t* col, int S,
                                            int i) {
  return (col[(i >> 2) * S] >> (8 * (i & 3))) & 0xFFu;
}

__device__ __forceinline__ int load_edge(const uint8_t* p) { return *p; }
__device__ __forceinline__ int load_edge(const uint16_t* p) { return *p; }
__device__ __forceinline__ int load_edge(const int* p) { return __ldg(p); }

// The tables every lane of the block reads: shared-memory copies, or
// the device-memory arrays themselves.
template <typename TabT>
struct Tables {
  const int4* instrs;
  const TabT* table;
};

template <typename TabT>
__device__ Tables<TabT> stage_tables(const Plan& p, unsigned char* smem,
                                     const int4* instrs, int ni,
                                     const void* table, int nb, int tid) {
  Tables<TabT> t{instrs, static_cast<const TabT*>(table)};
  if (p.instrs >= 0) {
    block_copy(smem + p.instrs, instrs, ni * 16, tid, p.threads);
    t.instrs = reinterpret_cast<const int4*>(smem + p.instrs);
  }
  if (p.table >= 0) {
    block_copy(smem + p.table, table,
               (nb + 1) * nb * static_cast<int>(sizeof(TabT)), tid,
               p.threads);
    t.table = reinterpret_cast<const TabT*>(smem + p.table);
  }
  return t;
}

struct VmOut {
  int status;
  int exit_code;
  int steps;
  uint32_t hash;
};

// Run one lane to halt, crash or max_steps.  `buf` is the lane's column
// of a lane-minor u32 array (byte i in word i / 4, words S apart),
// `regs` its column of the registers (register k at regs[k * T]), `mem`
// its first scratch cell (cells `mstride` ints apart), `counts` its
// zeroed u8 row of n_edges + 1 cells.
template <typename TabT>
__device__ VmOut vm_run(const Tables<TabT>& tab, int ni, int nb,
                        const uint32_t* buf, int S, int L, int len,
                        int* regs, int T, int* mem, int mstride,
                        int mem_size, int max_steps, uint8_t* counts) {
  for (int k = 0; k < 8; ++k) regs[k * T] = 0;
  for (int m = 0; m < mem_size; ++m) mem[m * mstride] = 0;
  int pc = 0, status = FUZZ_RUNNING, exit_code = 0, prev_idx = 0;
  int steps = 0;
  uint32_t hash = 0;
  while (steps < max_steps && status == FUZZ_RUNNING) {
    const int4 ins = tab.instrs[clampi(pc, 0, ni - 1)];
    const int op = ins.x, a = ins.y, b = ins.z, c = ins.w;
    // every shared-memory load a step may need is issued before the
    // dispatch, so their latencies overlap: the registers the op reads
    // (ALU's and BR's third register sits in another field) and the
    // input byte at rb
    const int ra = regs[clampi(a, 0, 7) * T];
    const int rb = regs[clampi(b, 0, 7) * T];
    const int ry = regs[(op == OP_ALU ? (c >> 3) & 7 : (b >> 2) & 7) * T];
    const int byte = static_cast<int>(buf_get(buf, S, clampi(rb, 0, L - 1)));
    bool crash = pc < 0 || pc >= ni;
    bool halt = false;
    bool writes = false;
    int wr = 0;
    int new_pc = pc + 1;
    switch (op) {
      case OP_HALT:
        halt = true;
        exit_code = a;
        break;
      case OP_BLOCK: {
        const int cur_loc = a & (MAP_SIZE - 1);
        const int cur_idx = clampi(b, 0, nb - 1);
        const int e = load_edge(&tab.table[prev_idx * nb + cur_idx]);
        counts[e] = static_cast<uint8_t>(counts[e] + 1);
        prev_idx = cur_idx + 1;
        hash = mix32(hash ^ static_cast<uint32_t>(cur_loc));
        break;
      }
      case OP_LDB:
        wr = (rb >= 0 && rb < len) ? byte : 0;
        writes = true;
        break;
      case OP_LDI:
        wr = b;
        writes = true;
        break;
      case OP_ALU: {
        const uint32_t x = static_cast<uint32_t>(rb);
        const uint32_t y = static_cast<uint32_t>(ry);
        const int sh = clampi(ry, 0, 31);
        uint32_t v = 0;
        switch (c & 7) {
          case 0: v = x + y; break;
          case 1: v = x - y; break;
          case 2: v = x & y; break;
          case 3: v = x | y; break;
          case 4: v = x ^ y; break;
          case 5: v = x << sh; break;
          case 6: v = x >> sh; break;
          default: v = x * y; break;
        }
        wr = static_cast<int>(v);
        writes = true;
        break;
      }
      case OP_ADDI:
        wr = static_cast<int>(static_cast<uint32_t>(rb) +
                              static_cast<uint32_t>(c));
        writes = true;
        break;
      case OP_JMP:
        new_pc = a;
        break;
      case OP_BR: {
        bool taken;
        switch (b & 3) {
          case 0: taken = ra == ry; break;
          case 1: taken = ra != ry; break;
          case 2: taken = ra < ry; break;
          default: taken = ra >= ry; break;
        }
        if (taken) new_pc = c;
        break;
      }
      case OP_CRASH:
        crash = true;
        break;
      case OP_LEN:
        wr = len;
        writes = true;
        break;
      case OP_LDM: {
        const bool ok = rb >= 0 && rb < mem_size;
        wr = ok ? mem[rb * mstride] : 0;
        writes = true;
        crash = crash || !ok;
        break;
      }
      case OP_STM: {
        const bool ok = ra >= 0 && ra < mem_size;
        if (ok) mem[ra * mstride] = rb;
        crash = crash || !ok;
        break;
      }
      default:
        break;
    }
    if (writes) regs[clampi(a, 0, 7) * T] = wr;
    status = crash ? FUZZ_CRASH : (halt ? FUZZ_NONE : status);
    pc = new_pc;
    ++steps;
  }
  return VmOut{status, exit_code, steps, hash};
}

// One stacked havoc edit (ops/mutate_core._havoc_one) on a lane's
// buffer `src` (a lane-minor column, words S apart).  Delete, insert
// and overwrite read the whole pre-edit buffer: they write `dst` and
// return true.  Every other op changes at most 4 bytes of `src` in
// place and returns false.  Updates `len`.
__device__ bool havoc_edit(uint32_t* src, uint32_t* dst, int S, int L,
                           int& len, const uint32_t (&w)[8]) {
  const int op = static_cast<int>(w[0] % 15u);
  const uint32_t maxlen = static_cast<uint32_t>(len > 1 ? len : 1);
  const int pos = static_cast<int>(w[1] % maxlen);
  const int pos2 = static_cast<int>(w[2] % maxlen);
  const uint32_t rbyte = w[3] % 256u;
  const uint32_t rint = w[4] & 0x7FFFFFFFu;
  const bool be = (w[5] & 1u) != 0;
  const int half = len / 2;
  const uint32_t blk_span = static_cast<uint32_t>(half > 2 ? half : 2) - 1u;
  const int blk = 1 + static_cast<int>(w[6] % (blk_span > 1u ? blk_span : 1u));
  const int bits = len * 8;
  const int bit = static_cast<int>(w[7] % static_cast<uint32_t>(bits > 1 ? bits : 1));
  const bool use_fill = (rint % 4u) == 0u;

  const bool is_del = op == 11 || op == 12;
  const bool is_ins = op == 13;
  const bool is_ovw = op == 14;
  if (is_del || is_ins || is_ovw) {
    // The output in segments: [0, pos) keeps its bytes; delete takes
    // [pos, L) from blk bytes further on; insert and overwrite put the
    // block at [pos, pos + blk) (a fill byte, or the bytes from pos2
    // on), and insert takes the rest from blk bytes back.  A word
    // inside one segment whose source bytes need no clamp is one
    // funnel shift of two source words; any other word (at a segment
    // edge, a clamp or the end of the buffer) is built byte by byte.
    const int end1 = is_del ? L : pos + blk;
    const int shift1 = is_del ? blk : pos2 - pos;
    const int shift2 = is_ins ? -blk : 0;
    const bool fill1 = !is_del && use_fill;
    const int words = (L + 3) / 4;
    for (int j = 0; j < words; ++j) {
      const int i0 = 4 * j, i3 = 4 * j + 3;
      const int seg = i0 < pos ? 0 : (i0 < end1 ? 1 : 2);
      const int seg3 = i3 < pos ? 0 : (i3 < end1 ? 1 : 2);
      const int a = i0 + (seg == 0 ? 0 : (seg == 1 ? shift1 : shift2));
      uint32_t word = 0;
      if (i3 < L && seg == seg3 && seg == 1 && fill1) {
        word = rbyte * 0x01010101u;
      } else if (i3 < L && seg == seg3 && a >= 0 && a + 3 <= L - 1) {
        const uint32_t lo = src[(a >> 2) * S];
        word = (a & 3) == 0
                   ? lo
                   : __funnelshift_r(lo, src[((a >> 2) + 1) * S], 8 * (a & 3));
      } else {
        for (int k = 0; k < 4; ++k) {
          const int idx = i0 + k;
          if (idx >= L) break;
          const bool in_ins = idx >= pos && idx < pos + blk;
          int s = idx;
          if (is_del) s = idx >= pos ? idx + blk : idx;
          else if (is_ins) s = idx >= pos + blk ? idx - blk : (in_ins ? pos2 + (idx - pos) : idx);
          else s = (in_ins && !use_fill) ? pos2 + (idx - pos) : idx;
          const bool in_fill = !is_del && use_fill && in_ins;
          const uint32_t out = in_fill ? rbyte : buf_get(src, S, clampi(s, 0, L - 1));
          word |= out << (8 * k);
        }
      }
      dst[j * S] = word;
    }
    if (is_del) {
      const int n = len - blk;
      len = n > 1 ? n : 1;
    } else if (is_ins) {
      const int n = len + blk;
      len = n < L ? n : L;
    }
    return true;
  }

  if (op == 0 || op == 10) {            // bit flip, xor byte
    const int xbyte = op == 0 ? (bit >> 3) : pos;
    const uint32_t xval = op == 0 ? (128u >> (bit & 7)) : (rbyte > 1u ? rbyte : 1u);
    if (xbyte < L) *buf_byte(src, S, xbyte) ^= static_cast<uint8_t>(xval);
    return false;
  }
  // interesting values (1-3) and arithmetic (4-9) on 1, 2 or 4 bytes
  const bool is_int = op <= 3;
  int width;
  if (is_int) width = op == 1 ? 1 : (op == 2 ? 2 : 4);
  else width = op <= 5 ? 1 : (op <= 7 ? 2 : 4);
  uint32_t cur = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    cur |= buf_get(src, S, clampi(pos + k, 0, L - 1)) << (8 * k);
  uint32_t cur_w;
  if (width == 1) {
    cur_w = cur & 0xFFu;
  } else if (width == 2) {
    cur_w = be ? (((cur & 0xFFu) << 8) | ((cur >> 8) & 0xFFu)) : (cur & 0xFFFFu);
  } else {
    cur_w = be ? (((cur & 0xFFu) << 24) | ((cur & 0xFF00u) << 8) |
                  ((cur >> 8) & 0xFF00u) | ((cur >> 24) & 0xFFu))
               : cur;
  }
  uint32_t int_val;
  if (op == 1) int_val = kInteresting8[rint % 9u];
  else if (op == 2) int_val = kInteresting16[rint % 10u];
  else int_val = kInteresting32[rint % 8u];
  const uint32_t delta = rint % 35u + 1u;
  const bool sign_add = op == 5 || op == 7 || op == 9;
  const uint32_t d = sign_add ? delta : 0u - delta;
  const uint32_t wmask = width == 1 ? 0xFFu : (width == 2 ? 0xFFFFu : 0xFFFFFFFFu);
  const uint32_t write_val = (is_int ? int_val : cur_w + d) & wmask;
  for (int off = 0; off < width; ++off) {
    const int idx = pos + off;
    if (idx >= L) break;
    const int k = be ? width - 1 - off : off;
    *buf_byte(src, S, idx) = static_cast<uint8_t>((write_val >> (8 * k)) & 0xFFu);
  }
  return false;
}

// Output arrays, one row or value per lane of the batch.
struct Out {
  int* status;
  int* exit_code;
  uint8_t* counts;     // u8[B][n_edges + 1]
  int* steps;
  int64_t* hash;       // the uint32 path hash
};

__device__ __forceinline__ void write_result(const Out& o, int lane,
                                             const VmOut& r) {
  o.status[lane] = r.status;
  o.exit_code[lane] = r.exit_code;
  o.steps[lane] = r.steps;
  o.hash[lane] = static_cast<int64_t>(r.hash);
}

// Copy a lane's buffer (lane-minor column) to a device-memory row.
__device__ __forceinline__ void store_row(uint8_t* row, const uint32_t* col,
                                          int S, int L) {
  if ((L & 3) == 0) {
    uint32_t* r = reinterpret_cast<uint32_t*>(row);
    for (int j = 0; j < L / 4; ++j) r[j] = col[j * S];
  } else {
    for (int i = 0; i < L; ++i) row[i] = static_cast<uint8_t>(buf_get(col, S, i));
  }
}

// Copy a device-memory row into a lane's buffer (lane-minor column).
__device__ __forceinline__ void load_row(uint32_t* col, const uint8_t* row,
                                         int S, int L) {
  if ((L & 3) == 0) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
    for (int j = 0; j < L / 4; ++j) col[j * S] = __ldg(&r[j]);
  } else {
    for (int j = 0; j < (L + 3) / 4; ++j) {
      uint32_t word = 0;
      for (int k = 0; k < 4 && 4 * j + k < L; ++k)
        word |= static_cast<uint32_t>(__ldg(&row[4 * j + k])) << (8 * k);
      col[j * S] = word;
    }
  }
}

// Word j of the seed u8[L], packed as the buffers hold it.
__device__ __forceinline__ uint32_t seed_word(const uint8_t* seed, int L,
                                              int j) {
  uint32_t word = 0;
  for (int k = 0; k < 4 && 4 * j + k < L; ++k)
    word |= static_cast<uint32_t>(__ldg(&seed[4 * j + k])) << (8 * k);
  return word;
}

// The device scratch array int32[mem_size + state rows][cols], column
// per lane: the VM's scratch cells in rows [0, mem_size), then, when
// the plan keeps the lane state in device memory, buffer k's words in
// rows mem_size + k * words + [0, words).
__device__ __forceinline__ uint32_t* scratch_buf(int* scratch, int cols,
                                                 int mem_size, int words,
                                                 int k, int col) {
  return reinterpret_cast<uint32_t*>(scratch) +
         static_cast<size_t>(mem_size + k * words) * cols + col;
}

// The fused fuzz step: lane i draws its havoc words from
// fold_in(base_key, its[i]), applies 2..2**stack_pow2 stacked edits to
// the seed and runs the mutant through the VM.  Block b owns lanes
// [b * blockDim, (b + 1) * blockDim); lane i's column of `scratch`
// (see scratch_buf) is i.  Without the lane state in shared memory
// (kShared false: the plan's buffers, seed and counts are -1) the
// counts go straight to the output rows, which the wrapper zeroes.
// The placement is a template parameter so that each instance's buffer
// accesses compile to loads and stores of one memory space, not to
// generic ones.
template <typename TabT, bool kShared>
__global__ void __launch_bounds__(256) kbz_fuzz_kernel(
    Plan p, const int4* __restrict__ instrs, int ni,
    const void* __restrict__ table, int nb,
    const uint8_t* __restrict__ ring, int L,
    const int* __restrict__ ring_lens, const int* __restrict__ sel,
    const int64_t* __restrict__ base_key, const int64_t* __restrict__ its,
    int stack_pow2, int B, int mem_size, int max_steps, int n_edges,
    int* scratch, int cols, Out out, uint8_t* bufs, int* lens) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.threads, tid = threadIdx.x;
  const int slot = __ldg(sel);
  const uint8_t* seed = ring + static_cast<size_t>(slot) * L;
  const int row0 = blockIdx.x * T;
  const int rows = B - row0 < T ? B - row0 : T;
  const int words = (L + 3) / 4;
  const int row_bytes = n_edges + 1;
  constexpr bool st = kShared;

  const Tables<TabT> tab = stage_tables<TabT>(p, smem, instrs, ni, table,
                                              nb, tid);
  uint32_t* seed_w =
      st ? reinterpret_cast<uint32_t*>(smem + p.seed) : nullptr;
  if (st) {
    for (int j = tid; j < words; j += T) seed_w[j] = seed_word(seed, L, j);
    uint32_t* counts_w = reinterpret_cast<uint32_t*>(smem + p.counts);
    for (int i = tid; i < (row_bytes * T + 3) / 4; i += T) counts_w[i] = 0;
  }
  __syncthreads();

  if (tid < rows) {
    const int lane = row0 + tid;
    const int S = st ? T : cols;
    uint32_t* cur =
        st ? reinterpret_cast<uint32_t*>(smem + p.buf0) + tid
           : scratch_buf(scratch, cols, mem_size, words, 0, lane);
    uint32_t* other =
        st ? reinterpret_cast<uint32_t*>(smem + p.buf1) + tid
           : scratch_buf(scratch, cols, mem_size, words, 1, lane);
    for (int j = 0; j < words; ++j)
      cur[j * S] = st ? seed_w[j] : seed_word(seed, L, j);
    uint32_t k0, k1;
    threefry_fold_in(static_cast<uint32_t>(__ldg(&base_key[0])),
                     static_cast<uint32_t>(__ldg(&base_key[1])),
                     static_cast<uint32_t>(__ldg(&its[lane])), k0, k1);
    int len = __ldg(&ring_lens[slot]);
    const uint32_t stack =
        1u << (1u + threefry_word(k0, k1, 0u) %
                        static_cast<uint32_t>(stack_pow2));
    for (uint32_t i = 0; i < stack; ++i) {
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = threefry_word(k0, k1, (i + 1) * 8 + k);
      if (havoc_edit(cur, other, S, L, len, w)) {
        uint32_t* t = cur;
        cur = other;
        other = t;
      }
    }
    store_row(bufs + static_cast<size_t>(lane) * L, cur, S, L);
    lens[lane] = len;
    uint8_t* counts = st ? smem + p.counts + tid * row_bytes
                         : out.counts + static_cast<size_t>(lane) * row_bytes;
    const VmOut r = vm_run<TabT>(
        tab, ni, nb, cur, S, L, len,
        reinterpret_cast<int*>(smem + p.regs) + tid, T, scratch + lane, cols,
        mem_size, max_steps, counts);
    write_result(out, lane, r);
  }
  if (st) {
    __syncthreads();
    block_copy(out.counts + static_cast<size_t>(row0) * row_bytes,
               smem + p.counts, rows * row_bytes, tid, T);
  }
}

// The VM over the inputs of the lanes named by `lanes` (its first
// *n_lanes entries), or over every lane when `lanes` is null.  Lanes
// not named are not written.  Without a list, block b owns lanes
// [b * blockDim, ...) and writes its counts as one contiguous copy, as
// kbz_fuzz_kernel does.  With one, the grid is persistent: slot s of
// the list runs on block s % gridDim.x, spread over that block's warps
// before its threads (see the header), and each lane's counts row is
// written by its thread.  A thread's column of `scratch` is its index
// in the grid.  Without the lane state in shared memory (kShared, as
// for kbz_fuzz_kernel) the counts go straight to the output rows,
// which the wrapper zeroes.
template <typename TabT, bool kShared>
__global__ void __launch_bounds__(256) kbz_vm_kernel(
    Plan p, const int4* __restrict__ instrs, int ni,
    const void* __restrict__ table, int nb,
    const uint8_t* __restrict__ inputs, int L,
    const int* __restrict__ lengths, const int* __restrict__ lanes,
    const int* __restrict__ n_lanes, int n_threads, int mem_size,
    int max_steps, int n_edges, int* scratch, int cols, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.threads, tid = threadIdx.x, G = gridDim.x;
  const int row_bytes = n_edges + 1;
  constexpr bool st = kShared;
  const Tables<TabT> tab = stage_tables<TabT>(p, smem, instrs, ni, table,
                                              nb, tid);
  const int phys = blockIdx.x * T + tid;
  const int S = st ? T : cols;
  uint32_t* buf =
      st ? reinterpret_cast<uint32_t*>(smem + p.buf0) + tid
         : scratch_buf(scratch, cols, mem_size, (L + 3) / 4, 0, phys);
  int* regs = reinterpret_cast<int*>(smem + p.regs) + tid;
  int* mem = scratch + phys;
  uint8_t* const own_counts = st ? smem + p.counts + tid * row_bytes
                                 : nullptr;

  if (lanes == nullptr) {
    const int row0 = blockIdx.x * T;
    const int rows = n_threads - row0 < T ? n_threads - row0 : T;
    if (st) {
      uint32_t* counts_w = reinterpret_cast<uint32_t*>(smem + p.counts);
      for (int i = tid; i < (row_bytes * T + 3) / 4; i += T) counts_w[i] = 0;
    }
    __syncthreads();
    if (tid < rows) {
      const int lane = row0 + tid;
      load_row(buf, inputs + static_cast<size_t>(lane) * L, S, L);
      uint8_t* counts =
          st ? own_counts : out.counts + static_cast<size_t>(lane) * row_bytes;
      write_result(out, lane,
                   vm_run<TabT>(tab, ni, nb, buf, S, L, __ldg(&lengths[lane]),
                                regs, T, mem, cols, mem_size, max_steps,
                                counts));
    }
    if (st) {
      __syncthreads();
      block_copy(out.counts + static_cast<size_t>(row0) * row_bytes,
                 smem + p.counts, rows * row_bytes, tid, T);
    }
    return;
  }

  __syncthreads();
  const int listed = __ldg(n_lanes);
  const int n = listed < n_threads ? listed : n_threads;
  const int warps = T / 32;
  const int first = ((tid % 32) * warps + tid / 32) * G + blockIdx.x;
  for (int s = first; s < n; s += G * T) {
    const int lane = __ldg(&lanes[s]);
    uint8_t* row = out.counts + static_cast<size_t>(lane) * row_bytes;
    load_row(buf, inputs + static_cast<size_t>(lane) * L, S, L);
    if (st)
      for (int e = 0; e < row_bytes; ++e) own_counts[e] = 0;
    write_result(out, lane,
                 vm_run<TabT>(tab, ni, nb, buf, S, L, __ldg(&lengths[lane]),
                              regs, T, mem, cols, mem_size, max_steps,
                              st ? own_counts : row));
    if (st)
      for (int e = 0; e < row_bytes; ++e) row[e] = own_counts[e];
  }
}

// ---- host launch code -------------------------------------------------

struct Choice {
  int threads, blocks_per_sm;
  Plan plan;
};

// The card's opt-in maximum of dynamic shared memory per block (one
// card per process).
int smem_max() {
  static int max = -1;
  if (max < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return max;
}

// The block size (256, 128, 64 or 32) that keeps the most threads
// resident per SM, its plan and residency; threads 0 when none fits.
// Raises the kernel's dynamic shared memory limit to the card's
// opt-in maximum first (needed above 48 KB).
Choice choose_block(const void* kernel, int ni, int instrs_shared, int nb,
                    int table_mode, int state_shared, int n_edges, int L,
                    int fuzz) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_max());
  Choice best{0, 0, Plan{}};
  for (int t = 256; t >= 32; t /= 2) {
    const Plan p = make_plan(t, ni, instrs_shared, nb, table_mode,
                             state_shared, n_edges, L, fuzz);
    if (p.bytes > smem_max()) continue;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, t,
                                                  p.bytes);
    if (blocks * t > best.blocks_per_sm * best.threads)
      best = Choice{t, blocks, p};
  }
  return best;
}

// Choices are cached by their inputs (one card per process), so the
// attribute and occupancy queries run once per program shape and not
// at every launch.
struct CacheEntry {
  const void* kernel;
  int key[8];
  Choice choice;
};
CacheEntry g_cache[16];
int g_cache_n = 0;

Choice cached_choice(const void* kernel, int ni, int instrs_shared, int nb,
                     int table_mode, int state_shared, int n_edges, int L,
                     int fuzz) {
  const int key[8] = {ni, instrs_shared, nb, table_mode, state_shared,
                      n_edges, L, fuzz};
  for (int i = 0; i < g_cache_n; ++i) {
    bool same = g_cache[i].kernel == kernel;
    for (int k = 0; k < 8 && same; ++k) same = g_cache[i].key[k] == key[k];
    if (same) return g_cache[i].choice;
  }
  const Choice c = choose_block(kernel, ni, instrs_shared, nb, table_mode,
                                state_shared, n_edges, L, fuzz);
  CacheEntry& e = g_cache[g_cache_n < 16 ? g_cache_n++ : 15];
  e.kernel = kernel;
  for (int k = 0; k < 8; ++k) e.key[k] = key[k];
  e.choice = c;
  return c;
}

void report(int* cfg, const Choice& c, int grid) {
  if (cfg == nullptr) return;
  cfg[0] = c.threads;
  cfg[1] = grid;
  cfg[2] = c.plan.bytes;
  cfg[3] = c.blocks_per_sm;
  cfg[4] = c.plan.buf0 >= 0;
}

template <typename TabT>
int fuzz_launch(const void* instrs, int ni, int instrs_shared,
                const void* table, int nb, int table_mode, int state_shared,
                const void* ring, int L, const void* ring_lens,
                const void* sel, const void* base_key,
                const void* its, int stack_pow2, int B, int mem_size,
                int max_steps, int n_edges, void* scratch, int cols, Out out,
                void* bufs, void* lens, cudaStream_t stream, int* cfg) {
  const auto kern = state_shared ? &kbz_fuzz_kernel<TabT, true>
                                 : &kbz_fuzz_kernel<TabT, false>;
  const void* kernel = reinterpret_cast<const void*>(kern);
  const Choice c = cached_choice(kernel, ni, instrs_shared, nb, table_mode,
                                 state_shared, n_edges, L, 1);
  if (c.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + c.threads - 1) / c.threads;
  report(cfg, c, grid);
  kern<<<grid, c.threads, c.plan.bytes, stream>>>(
      c.plan, static_cast<const int4*>(instrs), ni, table, nb,
      static_cast<const uint8_t*>(ring), L,
      static_cast<const int*>(ring_lens), static_cast<const int*>(sel),
      static_cast<const int64_t*>(base_key), static_cast<const int64_t*>(its),
      stack_pow2, B, mem_size, max_steps, n_edges, static_cast<int*>(scratch),
      cols, out, static_cast<uint8_t*>(bufs), static_cast<int*>(lens));
  return static_cast<int>(cudaGetLastError());
}

template <typename TabT>
int vm_launch(const void* instrs, int ni, int instrs_shared,
              const void* table, int nb, int table_mode, int state_shared,
              const void* inputs, int L, const void* lengths,
              const void* lanes, const void* n_lanes, int n_threads,
              int mem_size, int max_steps, int n_edges, void* scratch,
              int cols, Out out, cudaStream_t stream, int* cfg) {
  const auto kern = state_shared ? &kbz_vm_kernel<TabT, true>
                                 : &kbz_vm_kernel<TabT, false>;
  const void* kernel = reinterpret_cast<const void*>(kern);
  const Choice c = cached_choice(kernel, ni, instrs_shared, nb, table_mode,
                                 state_shared, n_edges, L, 0);
  if (c.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = vm_grid(n_threads, c.threads, c.blocks_per_sm * sms,
                           lanes != nullptr);
  report(cfg, c, grid);
  kern<<<grid, c.threads, c.plan.bytes, stream>>>(
      c.plan, static_cast<const int4*>(instrs), ni, table, nb,
      static_cast<const uint8_t*>(inputs), L,
      static_cast<const int*>(lengths), static_cast<const int*>(lanes),
      static_cast<const int*>(n_lanes), n_threads, mem_size, max_steps,
      n_edges, static_cast<int*>(scratch), cols, out);
  return static_cast<int>(cudaGetLastError());
}

Out make_out(void* status, void* exit_code, void* counts, void* steps,
             void* hash) {
  return Out{static_cast<int*>(status), static_cast<int*>(exit_code),
             static_cast<uint8_t*>(counts), static_cast<int*>(steps),
             static_cast<int64_t*>(hash)};
}

}  // namespace

// The rows of device scratch a lane's state needs beyond the VM's
// scratch cells: 0 when its buffers and counts row live in shared
// memory (lane_state_shared), else the words of its buffers (two
// buffers in the fused kernel, `fuzz` 1; one in the VM kernel).
extern "C" int kbz_state_rows(int fuzz, int ni, int instrs_shared, int nb,
                              int table_mode, int n_edges, int L) {
  if (lane_state_shared(smem_max(), ni, instrs_shared, nb, table_mode,
                        n_edges, L, fuzz))
    return 0;
  return (fuzz ? 2 : 1) * ((L + 3) / 4);
}

// `ring` is u8[S][L], `ring_lens` int32[S] and `sel` one int32, all in
// device memory: the seed is ring row *sel, of length ring_lens[*sel]
// (1..L).  `scratch` is int32[mem_size + state rows][cols] in device
// memory (see scratch_buf); `state_shared` is 1 when kbz_state_rows
// gave 0 rows.  `cfg` (may be null) receives the block size, the grid, the
// shared memory bytes per block, the resident blocks per SM and
// whether the lane state is in shared memory.  Returns
// cudaGetLastError().
extern "C" int kbz_fuzz_launch(
    const void* instrs, int ni, int instrs_shared, const void* table, int nb,
    int table_mode, int state_shared, const void* ring, int L,
    const void* ring_lens, const void* sel, const void* base_key,
    const void* its, int stack_pow2, int B, int mem_size, int max_steps,
    int n_edges, void* scratch, int cols,
    void* status, void* exit_code, void* counts, void* steps, void* hash,
    void* bufs, void* lens, void* stream, int* cfg) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Out out = make_out(status, exit_code, counts, steps, hash);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_mode) {
    case TABLE_U8:
      return fuzz_launch<uint8_t>(instrs, ni, instrs_shared, table, nb,
                                  table_mode, state_shared, ring, L,
                                  ring_lens, sel, base_key, its, stack_pow2,
                                  B, mem_size, max_steps, n_edges, scratch,
                                  cols, out, bufs, lens, s, cfg);
    case TABLE_U16:
      return fuzz_launch<uint16_t>(instrs, ni, instrs_shared, table, nb,
                                   table_mode, state_shared, ring, L,
                                   ring_lens, sel, base_key, its, stack_pow2,
                                   B, mem_size, max_steps, n_edges, scratch,
                                   cols, out, bufs, lens, s, cfg);
    default:
      return fuzz_launch<int>(instrs, ni, instrs_shared, table, nb,
                              TABLE_DEVICE, state_shared, ring, L, ring_lens,
                              sel, base_key, its, stack_pow2, B, mem_size,
                              max_steps, n_edges, scratch, cols, out, bufs,
                              lens, s, cfg);
  }
}

extern "C" int kbz_vm_launch(
    const void* instrs, int ni, int instrs_shared, const void* table, int nb,
    int table_mode, int state_shared, const void* inputs, int L,
    const void* lengths, const void* lanes, const void* n_lanes,
    int n_threads, int mem_size, int max_steps, int n_edges, void* scratch,
    int cols, void* status, void* exit_code, void* counts, void* steps,
    void* hash, void* stream, int* cfg) {
  if (n_threads <= 0) return static_cast<int>(cudaGetLastError());
  const Out out = make_out(status, exit_code, counts, steps, hash);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_mode) {
    case TABLE_U8:
      return vm_launch<uint8_t>(instrs, ni, instrs_shared, table, nb,
                                table_mode, state_shared, inputs, L, lengths,
                                lanes, n_lanes, n_threads, mem_size,
                                max_steps, n_edges, scratch, cols, out, s,
                                cfg);
    case TABLE_U16:
      return vm_launch<uint16_t>(instrs, ni, instrs_shared, table, nb,
                                 table_mode, state_shared, inputs, L,
                                 lengths, lanes, n_lanes, n_threads,
                                 mem_size, max_steps, n_edges, scratch, cols,
                                 out, s, cfg);
    default:
      return vm_launch<int>(instrs, ni, instrs_shared, table, nb,
                            TABLE_DEVICE, state_shared, inputs, L, lengths,
                            lanes, n_lanes, n_threads, mem_size, max_steps,
                            n_edges, scratch, cols, out, s, cfg);
  }
}
