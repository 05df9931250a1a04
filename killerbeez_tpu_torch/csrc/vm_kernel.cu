// KBVM kernels for Hopper (sm_90a): the fused havoc + VM kernel and
// the VM kernel, written by hand in CUDA C++.
//
// What they replace (killerbeez_tpu/ops/vm_kernel.py, Pallas on TPU):
//   kbz_fuzz_kernel  <- _fuzz_kernel (reached by fuzz_batch_pallas):
//                       havoc prologue (_havoc_edit) + VM loop (_vm_loop)
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
// ops/mutate_core._havoc_one: each edit reads the whole PRE-edit
// buffer, so two per-lane buffers ping-pong.
//
// What bounds them on this card: by the roofline (chip_smoke.py counts
// the bytes and the operations each run's data needs), kbz_fuzz_kernel
// is bound by bytes: a lane reads 544 bytes of havoc words and writes
// ~0.3 KB, while its VM steps and edits need a few hundred integer
// operations.  kbz_vm_kernel over the phase-2 survivors is bound by
// operations: the survivors are the long runs, ~200 steps of ~13
// operations each against ~0.3 KB moved.  In practice both run far
// from either bound, held by what the roofline does not see: lanes of
// a warp diverge (a warp runs until its longest lane stops, taking
// every branch any lane takes) and each step waits on dependent loads
// (instruction, register, edge table).
//
// The design, simple first: one thread per lane; the program tables
// (instructions int4[NI], edge table int[nb+1][nb]) are read through
// the read-only cache (__ldg); the eight VM registers are a per-thread
// array indexed directly (local memory, L1-cached: an unrolled select
// chain that kept them in registers was miscompiled at -O3 by nvcc 12.9
// for sm_90a, reading the wrong register); per-lane scratch memory is
// a global row laid out lane-minor ([mem_size][n]), so lanes of a warp
// that touch the same cell coalesce; edge counts are
// incremented in place in the u8 output row.  Phase 2 passes a lane
// list and its length as device pointers, so no host sync is needed to
// launch it: threads past the list's length return at once.  Shared
// memory staging of the tables, and anything faster, is later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FUZZ_NONE = 0;
constexpr int FUZZ_CRASH = 2;
constexpr int FUZZ_RUNNING = 3;
constexpr int MAP_SIZE = 1 << 16;
constexpr int THREADS = 128;

enum : int {
  OP_HALT = 0, OP_BLOCK = 1, OP_LDB = 2, OP_LDI = 3, OP_ALU = 4,
  OP_ADDI = 5, OP_JMP = 6, OP_BR = 7, OP_CRASH = 8, OP_LEN = 9,
  OP_LDM = 10, OP_STM = 11,
};

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

struct VmOut {
  int status;
  int exit_code;
  int steps;
  uint32_t hash;
};

// Run one lane to halt, crash or max_steps.  `mem` points at this
// lane's first scratch cell, cells `stride` ints apart; `counts` is the
// lane's zeroed u8 row of n_edges + 1 cells.
__device__ VmOut vm_run(const int4* __restrict__ instrs, int ni,
                        const int* __restrict__ table, int nb,
                        const uint8_t* buf, int L, int len,
                        int* mem, int stride, int mem_size, int max_steps,
                        uint8_t* counts) {
  int r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int m = 0; m < mem_size; ++m) mem[m * stride] = 0;
  int pc = 0, status = FUZZ_RUNNING, exit_code = 0, prev_idx = 0;
  int steps = 0;
  uint32_t hash = 0;
  while (steps < max_steps && status == FUZZ_RUNNING) {
    const int4 ins = __ldg(&instrs[clampi(pc, 0, ni - 1)]);
    const int op = ins.x, a = ins.y, b = ins.z, c = ins.w;
    const int ra = r[clampi(a, 0, 7)];
    const int rb = r[clampi(b, 0, 7)];
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
        const int e = __ldg(&table[prev_idx * nb + cur_idx]);
        counts[e] = static_cast<uint8_t>(counts[e] + 1);
        prev_idx = cur_idx + 1;
        hash = mix32(hash ^ static_cast<uint32_t>(cur_loc));
        break;
      }
      case OP_LDB:
        wr = (rb >= 0 && rb < len) ? buf[clampi(rb, 0, L - 1)] : 0;
        writes = true;
        break;
      case OP_LDI:
        wr = b;
        writes = true;
        break;
      case OP_ALU: {
        const int ry = r[(c >> 3) & 7];
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
        const int y = r[(b >> 2) & 7];
        bool taken;
        switch (b & 3) {
          case 0: taken = ra == y; break;
          case 1: taken = ra != y; break;
          case 2: taken = ra < y; break;
          default: taken = ra >= y; break;
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
        wr = ok ? mem[rb * stride] : 0;
        writes = true;
        crash = crash || !ok;
        break;
      }
      case OP_STM: {
        const bool ok = ra >= 0 && ra < mem_size;
        if (ok) mem[ra * stride] = rb;
        crash = crash || !ok;
        break;
      }
      default:
        break;
    }
    if (writes) r[clampi(a, 0, 7)] = wr;
    status = crash ? FUZZ_CRASH : (halt ? FUZZ_NONE : status);
    pc = new_pc;
    ++steps;
  }
  return VmOut{status, exit_code, steps, hash};
}

// One stacked havoc edit (ops/mutate_core._havoc_one): reads the whole
// pre-edit buffer `src`, writes `dst`, updates `len`.
__device__ void havoc_edit(const uint8_t* src, uint8_t* dst, int L,
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
  const uint32_t delta = rint % 35u + 1u;
  const bool use_fill = (rint % 4u) == 0u;

  const bool is_flip = op == 0;
  const bool is_int = op >= 1 && op <= 3;
  const bool is_arith = op >= 4 && op <= 9;
  const bool is_xor = op == 10;
  const bool is_del = op == 11 || op == 12;
  const bool is_ins = op == 13;
  const bool is_ovw = op == 14;
  const bool is_write = is_int || is_arith;

  int width = 1;
  if (is_int) width = op == 1 ? 1 : (op == 2 ? 2 : 4);
  else if (is_arith) width = op <= 5 ? 1 : (op <= 7 ? 2 : 4);

  uint32_t int_val;
  if (op == 1) int_val = kInteresting8[rint % 9u];
  else if (op == 2) int_val = kInteresting16[rint % 10u];
  else int_val = kInteresting32[rint % 8u];

  uint32_t cur = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    cur |= static_cast<uint32_t>(src[clampi(pos + k, 0, L - 1)]) << (8 * k);
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
  const bool sign_add = op == 5 || op == 7 || op == 9;
  const uint32_t d = sign_add ? delta : 0u - delta;
  const uint32_t wmask = width == 1 ? 0xFFu : (width == 2 ? 0xFFFFu : 0xFFFFFFFFu);
  const uint32_t write_val = (is_arith ? cur_w + d : int_val) & wmask;

  const uint8_t xval = static_cast<uint8_t>(
      is_flip ? (128u >> (bit & 7)) : (rbyte > 1u ? rbyte : 1u));
  const int xbyte = is_flip ? (bit >> 3) : pos;
  const bool xors = is_flip || is_xor;

  for (int idx = 0; idx < L; ++idx) {
    const bool in_ins = idx >= pos && idx < pos + blk;
    int s = idx;
    if (is_del) s = idx >= pos ? idx + blk : idx;
    else if (is_ins) s = idx >= pos + blk ? idx - blk : (in_ins ? pos2 + (idx - pos) : idx);
    else if (is_ovw) s = (in_ins && !use_fill) ? pos2 + (idx - pos) : idx;
    const uint8_t g = src[clampi(s, 0, L - 1)];
    const uint8_t xm = (xors && idx == xbyte) ? xval : 0;
    const int off = idx - pos;
    const int k = be ? width - 1 - off : off;
    const bool in_write = is_write && off >= 0 && off < width;
    const bool in_fill = (is_ins || is_ovw) && use_fill && in_ins;
    uint8_t out;
    if (in_write) out = static_cast<uint8_t>((write_val >> (8 * clampi(k, 0, 3))) & 0xFFu);
    else if (in_fill) out = static_cast<uint8_t>(rbyte);
    else out = static_cast<uint8_t>(g ^ xm);
    dst[idx] = out;
  }
  if (is_del) {
    const int n = len - blk;
    len = n > 1 ? n : 1;
  } else if (is_ins) {
    const int n = len + blk;
    len = n < L ? n : L;
  }
}

__global__ void kbz_fuzz_kernel(
    const int4* __restrict__ instrs, int ni, const int* __restrict__ table,
    int nb, const uint8_t* __restrict__ seed, int L, int seed_len,
    const uint32_t* __restrict__ words, int n_words, int stack_pow2, int B,
    int mem_size, int max_steps, int n_edges, uint8_t* scratch,
    int* mem, int* status, int* exit_code, uint8_t* counts, int* steps,
    uint32_t* path_hash, uint8_t* bufs, int* lens) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint8_t* out = bufs + static_cast<size_t>(lane) * L;
  uint8_t* other = scratch + static_cast<size_t>(lane) * L;
  for (int i = 0; i < L; ++i) out[i] = __ldg(&seed[i]);
  const uint32_t* lw = words + static_cast<size_t>(lane) * n_words;
  int len = seed_len;
  const uint32_t stack = 1u << (1u + __ldg(&lw[0]) % static_cast<uint32_t>(stack_pow2));
  uint8_t* cur = out;
  for (uint32_t i = 0; i < stack; ++i) {
    uint32_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = __ldg(&lw[(i + 1) * 8 + k]);
    uint8_t* nxt = cur == out ? other : out;
    havoc_edit(cur, nxt, L, len, w);
    cur = nxt;
  }
  if (cur != out)
    for (int i = 0; i < L; ++i) out[i] = cur[i];
  lens[lane] = len;
  const VmOut o = vm_run(instrs, ni, table, nb, out, L, len, mem + lane, B,
                         mem_size, max_steps,
                         counts + static_cast<size_t>(lane) * (n_edges + 1));
  status[lane] = o.status;
  exit_code[lane] = o.exit_code;
  steps[lane] = o.steps;
  path_hash[lane] = o.hash;
}

__global__ void kbz_vm_kernel(
    const int4* __restrict__ instrs, int ni, const int* __restrict__ table,
    int nb, const uint8_t* __restrict__ inputs, int L,
    const int* __restrict__ lengths, const int* __restrict__ lanes,
    const int* __restrict__ n_lanes, int n_threads, int mem_size,
    int max_steps, int n_edges, int* mem, int* status, int* exit_code,
    uint8_t* counts, int* steps, uint32_t* path_hash) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  int lane = t;
  if (lanes != nullptr) {
    if (t >= __ldg(n_lanes)) return;
    lane = __ldg(&lanes[t]);
  }
  const VmOut o = vm_run(instrs, ni, table, nb,
                         inputs + static_cast<size_t>(lane) * L, L,
                         __ldg(&lengths[lane]), mem + t, n_threads,
                         mem_size, max_steps,
                         counts + static_cast<size_t>(lane) * (n_edges + 1));
  status[lane] = o.status;
  exit_code[lane] = o.exit_code;
  steps[lane] = o.steps;
  path_hash[lane] = o.hash;
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int kbz_fuzz_launch(
    const void* instrs, int ni, const void* table, int nb, const void* seed,
    int L, int seed_len, const void* words, int n_words, int stack_pow2,
    int B, int mem_size, int max_steps, int n_edges, void* scratch,
    void* mem, void* status, void* exit_code, void* counts, void* steps,
    void* path_hash, void* bufs, void* lens, void* stream) {
  if (B > 0) {
    kbz_fuzz_kernel<<<blocks_for(B), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(instrs), ni, static_cast<const int*>(table),
        nb, static_cast<const uint8_t*>(seed), L, seed_len,
        static_cast<const uint32_t*>(words), n_words, stack_pow2, B,
        mem_size, max_steps, n_edges, static_cast<uint8_t*>(scratch),
        static_cast<int*>(mem), static_cast<int*>(status),
        static_cast<int*>(exit_code), static_cast<uint8_t*>(counts),
        static_cast<int*>(steps), static_cast<uint32_t*>(path_hash),
        static_cast<uint8_t*>(bufs), static_cast<int*>(lens));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kbz_vm_launch(
    const void* instrs, int ni, const void* table, int nb, const void* inputs,
    int L, const void* lengths, const void* lanes, const void* n_lanes,
    int n_threads, int mem_size, int max_steps, int n_edges, void* mem,
    void* status, void* exit_code, void* counts, void* steps,
    void* path_hash, void* stream) {
  if (n_threads > 0) {
    kbz_vm_kernel<<<blocks_for(n_threads), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(instrs), ni, static_cast<const int*>(table),
        nb, static_cast<const uint8_t*>(inputs), L,
        static_cast<const int*>(lengths), static_cast<const int*>(lanes),
        static_cast<const int*>(n_lanes), n_threads, mem_size, max_steps,
        n_edges, static_cast<int*>(mem), static_cast<int*>(status),
        static_cast<int*>(exit_code), static_cast<uint8_t*>(counts),
        static_cast<int*>(steps), static_cast<uint32_t*>(path_hash));
  }
  return static_cast<int>(cudaGetLastError());
}
