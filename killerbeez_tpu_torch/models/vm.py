"""KBVM — the batched bytecode VM, plain PyTorch engine.

One VM lane executes one candidate input; a batch dimension runs
thousands of lanes over a shared instruction tensor, with a static
step budget (the hang timeout: "ran out of steps without HALT").

Instruction format: int32[NI, 4] rows ``(opcode, a, b, c)``.

  op  name    semantics
  0   HALT    status = FUZZ_NONE, exit_code = a
  1   BLOCK   coverage: cur = a; edge = cur ^ prev; prev = cur >> 1
  2   LDB     r[a] = input[r[b]]  (0 if index out of [0, length))
  3   LDI     r[a] = b
  4   ALU     r[a] = r[b] <op c> r[(c >> 3) & 7] — c & 7 selects ADD/SUB/
              AND/OR/XOR/SHL/SHR/MUL
  5   ADDI    r[a] = r[b] + c
  6   JMP     pc = a
  7   BR      if r[a] <cmp b & 3> r[(b >> 2) & 7]: pc = c
  8   CRASH   status = FUZZ_CRASH
  9   LEN     r[a] = input length
  10  LDM     r[a] = mem[r[b]]; out of bounds -> FUZZ_CRASH
  11  STM     mem[r[a]] = r[b]; out of bounds -> FUZZ_CRASH

Registers: 8 x int32. Scratch memory: ``mem_size`` x int32 per lane.
Arithmetic wraps at 32 bits, shift counts clip to 0..31, SHR is
logical, compares are signed.

``_run_batch_impl`` here is the plain PyTorch version of the CUDA VM
kernel (``ops/vm_kernel.py``) and the port of the JAX package's
batched engine ``models/vm._run_batch_impl``: same five outputs, bit
for bit, and with ``record_stream`` the sixth, the per-step edge
stream (the tracer and ``ipt``'s filtered hashes read it; no kernel
records it yet, so on the card it runs as this plain engine).  It
gathers per lane (the TPU's one-hot selects are not semantics) and
carries int32 values in int64 so every wrap is explicit.  ``_run_one``
is the single-lane reference engine, on host integers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import FUZZ_CRASH, FUZZ_NONE, FUZZ_RUNNING, MAP_SIZE

N_REGS = 8

OP_HALT = 0
OP_BLOCK = 1
OP_LDB = 2
OP_LDI = 3
OP_ALU = 4
OP_ADDI = 5
OP_JMP = 6
OP_BR = 7
OP_CRASH = 8
OP_LEN = 9
OP_LDM = 10
OP_STM = 11
N_OPS = 12

ALU_ADD, ALU_SUB, ALU_AND, ALU_OR, ALU_XOR, ALU_SHL, ALU_SHR, ALU_MUL = \
    range(8)
CMP_EQ, CMP_NE, CMP_LT, CMP_GE = range(4)

M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Program:
    """A compiled target: shared instruction tensor + metadata.

    The coverage-edge universe of a KBVM program is static: every
    possible (prev BLOCK, next BLOCK) pair is enumerable from the
    instruction graph.  ``__post_init__`` derives it once
    (``compute_edges``), so the engines count hits in a dense
    uint8[B, n_edges+1] table and triage runs over the few hundred
    real edges.

    Derived fields (filled automatically):
      edge_from  int32[E]  source block index (-1 = program entry)
      edge_to    int32[E]  destination block index
      edge_slot  int32[E]  AFL map slot: to_id ^ (from_id >> 1)
      edge_table int32[n_blocks+1, n_blocks]  (from+1, to) -> edge
                 index; impossible pairs -> E (overflow column)
    """
    instrs: np.ndarray            # int32[NI, 4]
    name: str = "anon"
    mem_size: int = 64
    max_steps: int = 256          # hang budget (per-exec step cap)
    n_blocks: int = 0             # number of BLOCK instructions
    block_ids: Tuple[int, ...] = ()
    modules: Tuple[Tuple[str, int, int], ...] = ()  # (name, lo, hi) blocks
    edge_from: Optional[np.ndarray] = None
    edge_to: Optional[np.ndarray] = None
    edge_slot: Optional[np.ndarray] = None
    edge_table: Optional[np.ndarray] = None

    def __post_init__(self):
        assert self.instrs.ndim == 2 and self.instrs.shape[1] == 4
        assert self.instrs.dtype == np.int32
        # the bound the reference's f32-matmul fetch needs; kept so
        # both packages accept exactly the same programs
        if np.abs(self.instrs[:, 1:]).max(initial=0) >= (1 << 24):
            raise ValueError(
                "instruction field exceeds the batched engine's 2^24 "
                "exact-integer bound; build large constants with shl/or")
        if self.edge_table is None:
            instrs, ef, et, es, tbl, n_blocks, ids = compute_edges(
                self.instrs)
            object.__setattr__(self, "instrs", instrs)
            object.__setattr__(self, "edge_from", ef)
            object.__setattr__(self, "edge_to", et)
            object.__setattr__(self, "edge_table", tbl)
            if not self.n_blocks:
                object.__setattr__(self, "n_blocks", n_blocks)
            if not self.block_ids:
                object.__setattr__(self, "block_ids", ids)
            if not self.modules:
                object.__setattr__(
                    self, "modules", (("target", 0, self.n_blocks),))
            # per-module slot spaces: an edge lands in the map of its
            # DESTINATION block's module, at offset module * MAP_SIZE
            mod_of_block = np.zeros(max(self.n_blocks, 1),
                                    dtype=np.int64)
            for m, (_, lo, hi) in enumerate(self.modules):
                mod_of_block[lo:hi] = m
            es = es + (mod_of_block[et] * MAP_SIZE if len(et)
                       else 0)
            object.__setattr__(self, "edge_slot", es.astype(np.int32))
        n_dup = self.n_blocks - len(set(self.block_ids))
        if n_dup > 0:
            from ..utils.logging import WARNING_MSG
            WARNING_MSG(
                "program %r: %d duplicate coverage id(s) among %d "
                "blocks alias in the AFL map", self.name, n_dup,
                self.n_blocks)

    @classmethod
    def from_arrays(cls, instrs, name: str = "anon", mem_size: int = 64,
                    max_steps: int = 256, n_blocks: int = 0,
                    block_ids=(), modules=()) -> "Program":
        """A Program from another package's fields (numpy arrays and
        plain tuples, e.g. the JAX ``Program``'s).  The derived edge
        tables are recomputed here, never copied."""
        return cls(instrs=np.asarray(instrs, dtype=np.int32).copy(),
                   name=str(name), mem_size=int(mem_size),
                   max_steps=int(max_steps), n_blocks=int(n_blocks),
                   block_ids=tuple(int(b) for b in block_ids),
                   modules=tuple((str(n), int(lo), int(hi))
                                 for n, lo, hi in modules))

    @property
    def n_edges(self) -> int:
        return int(self.edge_from.shape[0])

    @property
    def map_size(self) -> int:
        """Total coverage-map bytes: one 64KB map per module."""
        return max(len(self.modules), 1) * MAP_SIZE

    @property
    def module_names(self) -> Tuple[str, ...]:
        return tuple(m[0] for m in self.modules)


def compute_edges(instrs: np.ndarray):
    """Enumerate the static edge universe of an instruction tensor.

    Returns ``(instrs', edge_from, edge_to, edge_slot, edge_table,
    n_blocks, block_ids)`` where instrs' is a copy with each BLOCK
    row's b field set to the block's ordinal index (the engine reads
    it to key the edge table).

    An edge (f, t) exists when some instruction path runs from block
    f's body to block t's BLOCK head without crossing another BLOCK;
    f = -1 models the entry path (prev_loc starts at 0, so the slot is
    just t's id).
    """
    ni = instrs.shape[0]
    instrs = instrs.copy()
    block_pcs = [pc for pc in range(ni) if instrs[pc, 0] == OP_BLOCK]
    idx_of_pc = {pc: k for k, pc in enumerate(block_pcs)}
    for k, pc in enumerate(block_pcs):
        instrs[pc, 2] = k
    nb = len(block_pcs)
    ids = tuple(int(instrs[pc, 1]) & (MAP_SIZE - 1) for pc in block_pcs)

    def succs(pc):
        op, a, b, c = instrs[pc]
        if op in (OP_HALT, OP_CRASH):
            return []
        if op == OP_JMP:
            return [int(a)]
        if op == OP_BR:
            return [int(c), pc + 1]
        return [pc + 1]

    pairs = set()

    def walk(from_idx, start_pc):
        seen = set()
        stack = [start_pc]
        while stack:
            pc = stack.pop()
            if pc in seen or pc < 0 or pc >= ni:
                continue           # out-of-range pc = crash, no edge
            seen.add(pc)
            if instrs[pc, 0] == OP_BLOCK:
                pairs.add((from_idx, idx_of_pc[pc]))
                continue
            stack.extend(succs(pc))

    walk(-1, 0)
    for k, pc in enumerate(block_pcs):
        walk(k, pc + 1)

    order = sorted(pairs)
    e = len(order)
    edge_from = np.array([f for f, _ in order] or [], dtype=np.int32)
    edge_to = np.array([t for _, t in order] or [], dtype=np.int32)
    slot = []
    for f, t in order:
        prev_loc = 0 if f < 0 else (ids[f] >> 1)
        slot.append(ids[t] ^ prev_loc)
    edge_slot = np.array(slot or [], dtype=np.int32)
    edge_table = np.full((nb + 1, max(nb, 1)), e, dtype=np.int32)
    for k, (f, t) in enumerate(order):
        edge_table[f + 1, t] = k
    return (instrs, edge_from, edge_to, edge_slot, edge_table, nb, ids)


class VMResult(NamedTuple):
    """Per-lane execution outcome (torch tensors on the batch's
    device).  ``counts`` is the hit-count table over the program's
    static edge universe (last column = overflow for pairs outside
    it); ``path_hash`` is the order-aware murmur fold of the block
    ids a lane executed, a uint32 carried in int64.  ``edge_ids`` is
    the optional time-ordered edge stream: entry i is ``cur_loc ^
    prev_loc`` when the lane ran a BLOCK at global step i, else -1
    (None unless the engine was asked to record it)."""
    status: torch.Tensor      # int32[B]: FUZZ_NONE / FUZZ_CRASH / RUNNING
    exit_code: torch.Tensor   # int32[B]
    counts: torch.Tensor      # uint8[B, E+1] static-edge hit counts
    steps: torch.Tensor       # int32[B] steps actually executed
    path_hash: torch.Tensor   # int64[B] holding uint32
    edge_ids: Optional[torch.Tensor] = None   # int32[B, max_steps]


def _wrap32(x):
    """int64 (a tensor or a host int) -> the int32 value with the same
    low 32 bits: two's-complement wrap, written out so it is
    defined."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def _mix32(x):
    """murmur3 finalizer over uint32 values carried in int64 (a tensor
    or a host int)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    x = x ^ (x >> 16)
    return x


def _step(instrs, edge_table, input_buf, input_len, mem_size, state):
    """One VM step for one lane, on host integers: the readable
    reference engine the batched one is held to.  ``instrs`` and
    ``edge_table`` are nested lists, ``input_buf`` a list of bytes.
    state = (pc, regs, mem, prev_loc, status, exit_code, prev_idx,
    counts, path_hash); regs, mem and counts are lists, updated in
    place.  Returns (state, edge_id), edge_id -1 unless the lane ran a
    BLOCK."""
    (pc, regs, mem, prev_loc, status, exit_code, prev_idx, counts,
     path_hash) = state
    ni = len(instrs)
    op, a, b, c = instrs[min(max(pc, 0), ni - 1)]
    running = status == FUZZ_RUNNING
    if not running:
        return state, -1

    def clip(x, lo, hi):
        return min(max(x, lo), hi)

    ra = regs[clip(a, 0, N_REGS - 1)]
    rb = regs[clip(b, 0, N_REGS - 1)]
    new_pc = pc + 1
    crashes = pc < 0 or pc >= ni
    wr = None
    if op == OP_LDB:
        ok = 0 <= rb < input_len
        wr = input_buf[clip(rb, 0, len(input_buf) - 1)] if ok else 0
    elif op == OP_LDI:
        wr = b
    elif op == OP_ALU:
        x, y = rb, regs[(c >> 3) & (N_REGS - 1)]
        shift = clip(y, 0, 31)
        sel = c & 7
        wr = _wrap32((x + y, x - y, x & y, x | y, x ^ y,
                        (x & M32) << shift, (x & M32) >> shift,
                        x * y)[sel])
    elif op == OP_ADDI:
        wr = _wrap32(rb + c)
    elif op == OP_JMP:
        new_pc = a
    elif op == OP_BR:
        y = regs[(b >> 2) & (N_REGS - 1)]
        taken = (ra == y, ra != y, ra < y, ra >= y)[b & 3]
        new_pc = c if taken else pc + 1
    elif op == OP_CRASH:
        crashes = True
    elif op == OP_LEN:
        wr = input_len
    elif op == OP_LDM:
        if 0 <= rb < mem_size:
            wr = mem[rb]
        else:
            wr, crashes = 0, True
    elif op == OP_STM:
        if 0 <= ra < mem_size:
            mem[ra] = rb
        else:
            crashes = True
    if wr is not None:
        regs[clip(a, 0, N_REGS - 1)] = wr

    edge_id = -1
    if op == OP_BLOCK:
        cur_loc = a & (MAP_SIZE - 1)
        edge_id = cur_loc ^ prev_loc
        nb = len(edge_table[0])
        cur_idx = clip(b, 0, nb - 1)
        e = edge_table[clip(prev_idx, 0, nb)][cur_idx]
        counts[e] = (counts[e] + 1) & 0xFF
        prev_loc, prev_idx = cur_loc >> 1, cur_idx + 1
        path_hash = _mix32(path_hash ^ cur_loc)
    if op == OP_HALT:
        exit_code = a
    if crashes:
        status = FUZZ_CRASH
    elif op == OP_HALT:
        status = FUZZ_NONE
    return (new_pc, regs, mem, prev_loc, status, exit_code, prev_idx,
            counts, path_hash), edge_id


def _run_one(instrs, edge_table, n_edges, mem_size, max_steps,
             input_buf, input_len) -> VMResult:
    """Execute one lane to halt, crash or the step budget with the
    single-lane reference engine (``_step``).  ``input_buf`` is a
    uint8[L] tensor; the result's fields are tensors on its device
    (status, exit_code, steps, path_hash 0-d; counts uint8[E+1];
    edge_ids int32[max_steps], -1 where no BLOCK ran)."""
    dev = input_buf.device
    instrs = torch.as_tensor(instrs).tolist()
    edge_table = torch.as_tensor(edge_table).tolist()
    buf = input_buf.tolist()
    state = (0, [0] * N_REGS, [0] * mem_size, 0, FUZZ_RUNNING, 0, 0,
             [0] * (n_edges + 1), 0)
    edges = [-1] * max_steps
    i = 0
    while state[4] == FUZZ_RUNNING and i < max_steps:
        state, edges[i] = _step(instrs, edge_table, buf, int(input_len),
                                mem_size, state)
        i += 1

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return VMResult(status=i32(state[4]), exit_code=i32(state[5]),
                    counts=torch.tensor(state[7], dtype=torch.uint8,
                                        device=dev),
                    steps=i32(i),
                    path_hash=torch.tensor(state[8], dtype=torch.int64,
                                           device=dev),
                    edge_ids=i32(edges))


def _step_batched(instrs, edge_table, inputs, lengths, mem_size, state,
                  record_stream=False):
    """One VM step for every lane of ``state`` (all running at entry
    or frozen: lanes that are not running change nothing).  State is
    int64: (pc, regs [B, 9], mem [B, mem_size + 1], status, exit_code,
    prev_idx, counts [B, E+1], path_hash, lane_steps, prev_loc); the
    last column of regs and mem is a sink for writes that do not
    happen.  regs, mem and counts are updated in place; prev_loc only
    moves when ``record_stream``.  Returns (state, edge): edge is this
    step's stream entry per lane (``cur_loc ^ prev_loc`` at a BLOCK,
    else -1) when ``record_stream``, else None."""
    (pc, regs, mem, status, exit_code, prev_idx, counts, path_hash,
     lane_steps, prev_loc) = state
    ni = instrs.shape[0]
    L = inputs.shape[1]
    nb = edge_table.shape[1]
    running = status == FUZZ_RUNNING

    row = instrs[pc.clamp(0, ni - 1)]                       # [B, 4]
    op, a, b, c = row.unbind(1)

    def reg(i):
        return regs.gather(1, i[:, None])[:, 0]

    ra = reg(a.clamp(0, N_REGS - 1))
    rb = reg(b.clamp(0, N_REGS - 1))
    ry = reg((c >> 3) & (N_REGS - 1))
    cmp_y = reg((b >> 2) & (N_REGS - 1))
    alu_sel = c & 7
    cmp_sel = b & 3

    ldb_ok = (rb >= 0) & (rb < lengths)
    ldb_val = inputs.gather(1, rb.clamp(0, L - 1)[:, None])[:, 0]
    ldb_val = torch.where(ldb_ok, ldb_val, 0)

    x, y = rb, ry
    shift = y.clamp(0, 31)
    alu_val = torch.zeros_like(x)
    for sel, val in ((ALU_ADD, lambda: x + y), (ALU_SUB, lambda: x - y),
                     (ALU_AND, lambda: x & y), (ALU_OR, lambda: x | y),
                     (ALU_XOR, lambda: x ^ y),
                     (ALU_SHL, lambda: (x & M32) << shift),
                     (ALU_SHR, lambda: (x & M32) >> shift),
                     (ALU_MUL, lambda: x * y)):
        alu_val = torch.where(alu_sel == sel, val(), alu_val)
    alu_val = _wrap32(alu_val)
    taken = torch.where(
        cmp_sel == CMP_EQ, ra == cmp_y,
        torch.where(cmp_sel == CMP_NE, ra != cmp_y,
                    torch.where(cmp_sel == CMP_LT, ra < cmp_y,
                                ra >= cmp_y)))

    mem_ok_ld = (rb >= 0) & (rb < mem_size)
    ldm_val = mem.gather(1, rb.clamp(0, mem_size - 1)[:, None])[:, 0]
    ldm_val = torch.where(mem_ok_ld, ldm_val, 0)
    mem_ok_st = (ra >= 0) & (ra < mem_size)

    nxt = pc + 1
    new_pc = torch.where(op == OP_JMP, a,
                         torch.where((op == OP_BR) & taken, c, nxt))
    wr_val = torch.zeros_like(pc)
    for o, val in ((OP_LDB, ldb_val), (OP_LDI, b), (OP_ALU, alu_val),
                   (OP_ADDI, _wrap32(rb + c)), (OP_LEN, lengths),
                   (OP_LDM, ldm_val)):
        wr_val = torch.where(op == o, val, wr_val)
    writes_reg = ((op == OP_LDB) | (op == OP_LDI) | (op == OP_ALU)
                  | (op == OP_ADDI) | (op == OP_LEN) | (op == OP_LDM))
    regs.scatter_(1, torch.where(writes_reg & running,
                                 a.clamp(0, N_REGS - 1), N_REGS)[:, None],
                  wr_val[:, None])
    do_store = (op == OP_STM) & mem_ok_st & running
    mem.scatter_(1, torch.where(do_store, ra.clamp(0, mem_size - 1),
                                mem_size)[:, None], rb[:, None])

    crashes = ((op == OP_CRASH) | ((op == OP_LDM) & ~mem_ok_ld)
               | ((op == OP_STM) & ~mem_ok_st) | (pc < 0) | (pc >= ni))
    halts = op == OP_HALT
    new_status = torch.where(
        crashes, FUZZ_CRASH, torch.where(halts, FUZZ_NONE, status))
    new_exit = torch.where(halts & running, a, exit_code)

    is_block = (op == OP_BLOCK) & running
    cur_loc = a & (MAP_SIZE - 1)
    cur_idx = b.clamp(0, nb - 1)
    eidx = edge_table[prev_idx, cur_idx]
    counts.scatter_add_(1, eidx[:, None],
                        is_block.to(counts.dtype)[:, None])
    new_prev_idx = torch.where(is_block, cur_idx + 1, prev_idx)
    new_hash = torch.where(is_block, _mix32(path_hash ^ cur_loc),
                           path_hash)
    edge = None
    if record_stream:
        edge = torch.where(is_block, cur_loc ^ prev_loc, -1)
        prev_loc = torch.where(is_block, cur_loc >> 1, prev_loc)

    return (torch.where(running, new_pc, pc), regs, mem,
            torch.where(running, new_status, status),
            torch.where(running, new_exit, exit_code),
            new_prev_idx, counts, new_hash,
            lane_steps + running.to(lane_steps.dtype), prev_loc), edge


def _run_batch_impl(instrs, edge_table, inputs, lengths, mem_size,
                    max_steps, n_edges, record_stream=False) -> VMResult:
    """Run a uint8[B, L] batch to halt, crash or ``max_steps``: the
    plain PyTorch VM.  ``instrs``/``edge_table`` are int tensors.
    ``record_stream`` also returns the edge stream (``edge_ids``).

    Every 16 steps the lanes that stopped running are retired: their
    outputs are written and the step continues on the lanes still
    running only (a stopped lane's state never changes, so this is
    the same result at a fraction of the work).  The stream is written
    straight into the output rows at the global step index, so a
    retired lane keeps its -1 tail."""
    dev = inputs.device
    b = inputs.shape[0]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    out = VMResult(status=torch.full((b,), FUZZ_RUNNING, dtype=torch.int32,
                                     device=dev),
                   exit_code=torch.zeros(b, dtype=torch.int32, device=dev),
                   counts=torch.zeros((b, n_edges + 1), dtype=torch.uint8,
                                      device=dev),
                   steps=torch.zeros(b, dtype=torch.int32, device=dev),
                   path_hash=zeros(b),
                   edge_ids=(torch.full((b, max_steps), -1,
                                        dtype=torch.int32, device=dev)
                             if record_stream else None))
    state = (zeros(b), zeros(b, N_REGS + 1), zeros(b, mem_size + 1),
             torch.full((b,), FUZZ_RUNNING, dtype=torch.int64, device=dev),
             zeros(b), zeros(b), zeros(b, n_edges + 1), zeros(b), zeros(b),
             zeros(b))
    instrs = instrs.to(device=dev, dtype=torch.int64)
    edge_table = edge_table.to(device=dev, dtype=torch.int64)
    inputs = inputs.to(torch.int64)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    lanes = torch.arange(b, device=dev)

    def retire(sel):
        idx = lanes[sel]
        out.status[idx] = state[3][sel].to(torch.int32)
        out.exit_code[idx] = state[4][sel].to(torch.int32)
        out.counts[idx] = (state[6][sel] & 0xFF).to(torch.uint8)
        out.steps[idx] = state[8][sel].to(torch.int32)
        out.path_hash[idx] = state[7][sel]

    for i in range(max_steps):
        if i % 16 == 0:
            running = state[3] == FUZZ_RUNNING
            if not bool(running.all()):
                retire(~running)
                if not bool(running.any()):
                    lanes = lanes[:0]
                    break
                state = tuple(t[running] for t in state)
                inputs, lengths, lanes = (inputs[running],
                                          lengths[running],
                                          lanes[running])
        state, edge = _step_batched(instrs, edge_table, inputs, lengths,
                                    mem_size, state, record_stream)
        if record_stream:
            out.edge_ids[lanes, i] = edge.to(torch.int32)
    if lanes.numel():
        retire(torch.ones(lanes.shape[0], dtype=torch.bool, device=dev))
    return out


def run_batch(program: Program, inputs: torch.Tensor,
              lengths: torch.Tensor, record_stream: bool = False
              ) -> VMResult:
    """Execute a uint8[B, L] candidate batch through the program with
    the plain engine.  Lanes still RUNNING after ``max_steps`` are
    hangs (callers map FUZZ_RUNNING -> FUZZ_HANG).

    ``record_stream=True`` also records the [B, max_steps] edge stream
    (``VMResult.edge_ids``).  The JAX package's ``run_batch`` defaults
    to ``True``; here the default stays ``False``, so callers that want
    the stream (and tests holding the two packages together) pass the
    argument explicitly on both sides."""
    dev = inputs.device
    return _run_batch_impl(torch.as_tensor(program.instrs, device=dev),
                           torch.as_tensor(program.edge_table, device=dev),
                           inputs, lengths, program.mem_size,
                           program.max_steps, program.n_edges,
                           record_stream)


# --------------------------------------------------------------------
# Distance-returning execute variant (the gradient-search objective)
# --------------------------------------------------------------------
#
# Angora (arxiv 1803.01307) treats an uncracked branch as a black-box
# distance function over the input bytes and descends it; the batched
# engine makes the expensive half of that — "evaluate the objective on
# thousands of candidate inputs" — one device dispatch.  The variant
# below threads a per-lane best-distance accumulator through the SAME
# ``_step_batched`` transition as the production engine: coverage
# counts, statuses, steps and path hashes are bit-identical when the
# distance output is ignored.  It runs as plain torch ops on the card
# too (the JAX package runs it in XLA, outside any Pallas kernel).

#: distance of a lane that never reached the target branch while in
#: the objective's source block (float32-representable "infinity")
DIST_UNREACHED = 3.0e38


def _branch_distance(sel: int, x, y):
    """Angora's branch-distance table for ONE comparison direction:
    0.0 exactly when ``x <sel> y`` holds (judged in exact int32), a
    positive float32 magnitude otherwise (at least 1).  ``sel`` is the
    CANONICAL compare — callers wanting the fall-through successor
    pass the negated compare (eq<->ne, lt<->ge), so distance 0 always
    means "the branch goes the way the target edge needs".  ``x``/``y``
    are int64 tensors holding int32 values."""
    xf = x.to(torch.int32).to(torch.float32)
    yf = y.to(torch.int32).to(torch.float32)
    if sel == CMP_EQ:
        sat = x == y
        mag = (xf - yf).abs()
    elif sel == CMP_NE:
        sat = x != y
        mag = torch.ones_like(xf)
    elif sel == CMP_LT:
        sat = x < y
        mag = xf - yf + 1.0
    else:  # CMP_GE
        sat = x >= y
        mag = yf - xf
    return torch.where(sat, torch.zeros_like(mag), mag.clamp(min=1.0))


def _dist_loop_core(instrs, edge_table, inputs, lengths, mem_size,
                    max_steps, n_edges, specs, capture):
    """``_run_batch_impl`` plus per-lane min-distance accumulators
    for K observed branches at once — the shared core of
    ``run_batch_distances`` and the device descent loop
    (``search/device_descent.py``).

    ``specs`` is a tuple of ``(branch_pc, from_idx, sel, x_idx,
    y_idx)`` tuples.  Each distance is sampled from the state ENTERING
    a step, before ``_step_batched`` runs it, whenever a still-running
    lane is about to execute that branch pc with that source block as
    its last block (``prev_idx == from_idx + 1`` — the edge-table row
    key), so the observations never perturb the transition.

    ``capture`` also records the CONCRETE compare operand values at
    the min-distance sample of each spec: int32[B, K] ``x``/``y``
    register values (zeros-shaped [B, 0] when capture is off).

    Lanes that stopped running retire every 16 steps, as in
    ``_run_batch_impl``: a stopped lane samples nothing more.
    Returns ``(VMResult, best float32[B, K], cap_x, cap_y)``."""
    dev = inputs.device
    b = inputs.shape[0]
    k_n = len(specs)
    k_cap = k_n if capture else 0

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    out = VMResult(status=torch.full((b,), FUZZ_RUNNING, dtype=torch.int32,
                                     device=dev),
                   exit_code=torch.zeros(b, dtype=torch.int32, device=dev),
                   counts=torch.zeros((b, n_edges + 1), dtype=torch.uint8,
                                      device=dev),
                   steps=torch.zeros(b, dtype=torch.int32, device=dev),
                   path_hash=zeros(b))
    best_out = torch.full((b, k_n), DIST_UNREACHED, dtype=torch.float32,
                          device=dev)
    cx_out = torch.zeros((b, k_cap), dtype=torch.int32, device=dev)
    cy_out = torch.zeros((b, k_cap), dtype=torch.int32, device=dev)
    state = (zeros(b), zeros(b, N_REGS + 1), zeros(b, mem_size + 1),
             torch.full((b,), FUZZ_RUNNING, dtype=torch.int64, device=dev),
             zeros(b), zeros(b), zeros(b, n_edges + 1), zeros(b), zeros(b),
             zeros(b))
    best, cap_x, cap_y = best_out.clone(), cx_out.clone(), cy_out.clone()
    instrs = instrs.to(device=dev, dtype=torch.int64)
    edge_table = edge_table.to(device=dev, dtype=torch.int64)
    inputs = inputs.to(torch.int64)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    lanes = torch.arange(b, device=dev)

    def retire(sel):
        idx = lanes[sel]
        out.status[idx] = state[3][sel].to(torch.int32)
        out.exit_code[idx] = state[4][sel].to(torch.int32)
        out.counts[idx] = (state[6][sel] & 0xFF).to(torch.uint8)
        out.steps[idx] = state[8][sel].to(torch.int32)
        out.path_hash[idx] = state[7][sel]
        best_out[idx] = best[sel]
        cx_out[idx] = cap_x[sel]
        cy_out[idx] = cap_y[sel]

    for i in range(max_steps):
        if i % 16 == 0:
            running = state[3] == FUZZ_RUNNING
            if not bool(running.all()):
                retire(~running)
                if not bool(running.any()):
                    lanes = lanes[:0]
                    break
                state = tuple(t[running] for t in state)
                best, cap_x, cap_y = (best[running], cap_x[running],
                                      cap_y[running])
                inputs, lengths, lanes = (inputs[running],
                                          lengths[running],
                                          lanes[running])
        pc, regs, prev_idx = state[0], state[1], state[5]
        running = state[3] == FUZZ_RUNNING
        for k, (branch_pc, from_idx, sel, x_idx, y_idx) in \
                enumerate(specs):
            at = (pc == branch_pc) & (prev_idx == from_idx + 1) & running
            x, y = regs[:, x_idx], regs[:, y_idx]
            d = _branch_distance(sel, x, y)
            cur = best[:, k]
            if capture:
                upd = at & (d < cur)
                cap_x[:, k] = torch.where(upd, x.to(torch.int32),
                                          cap_x[:, k])
                cap_y[:, k] = torch.where(upd, y.to(torch.int32),
                                          cap_y[:, k])
            best[:, k] = torch.where(at, torch.minimum(cur, d), cur)
        state, _ = _step_batched(instrs, edge_table, inputs, lengths,
                                 mem_size, state)
    if lanes.numel():
        retire(torch.ones(lanes.shape[0], dtype=torch.bool, device=dev))
    return out, best_out, cx_out, cy_out


def run_batch_distances(program: Program, inputs: torch.Tensor,
                        lengths: torch.Tensor, specs,
                        capture_operands: bool = False):
    """Execute a uint8[B, L] candidate batch (on its device) and
    return, per lane, the minimum branch distance observed at each of
    the K ``specs`` (tuples of ``(branch_pc, from_idx, sel, x_idx,
    y_idx)``) — float32[B, K], ``DIST_UNREACHED`` where never
    sampled.  The VMResult is bit-identical to ``run_batch(...,
    record_stream=False)``.  ``search/objective.py`` derives specs
    from target edges.

    ``capture_operands=True`` returns ``(res, dists, cap_x, cap_y)``
    where the int32[B, K] capture arrays hold the concrete compare
    operand values observed at each spec's min-distance sample (0
    where never sampled — check ``dists`` for reachability)."""
    specs = tuple(tuple(int(v) for v in s) for s in specs)
    if not specs:
        raise ValueError("at least one branch spec is required")
    dev = inputs.device
    res, best, cap_x, cap_y = _dist_loop_core(
        torch.as_tensor(program.instrs, device=dev),
        torch.as_tensor(program.edge_table, device=dev), inputs, lengths,
        program.mem_size, program.max_steps, program.n_edges, specs,
        capture_operands)
    if capture_operands:
        return res, best, cap_x, cap_y
    return res, best


def run_batch_distance(program: Program, inputs: torch.Tensor,
                       lengths: torch.Tensor, *, branch_pc: int,
                       from_idx: int, sel: int, x_idx: int,
                       y_idx: int) -> Tuple[VMResult, torch.Tensor]:
    """Single-branch convenience wrapper over ``run_batch_distances``
    (returns float32[B])."""
    res, best = run_batch_distances(
        program, inputs, lengths,
        ((branch_pc, from_idx, sel, x_idx, y_idx),))
    return res, best[:, 0]


def compile_runner(program: Program, record_stream: bool = True):
    """A ``(inputs, lengths) -> VMResult`` closure over ``program``
    (the plain engine, the stream recorded by default as in the JAX
    package); the program's tables are placed once per device."""
    tables = {}

    def runner(inputs, lengths):
        dev = inputs.device
        if dev not in tables:
            tables[dev] = (torch.as_tensor(program.instrs, device=dev),
                           torch.as_tensor(program.edge_table, device=dev))
        return _run_batch_impl(*tables[dev], inputs, lengths,
                               program.mem_size, program.max_steps,
                               program.n_edges, record_stream)

    return runner
