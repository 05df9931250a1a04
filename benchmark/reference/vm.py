"""The KBVM: a compiled target program and the batched plain VM.

Instructions are int32[NI, 4] rows ``(opcode, a, b, c)``:

  0 HALT (exit a)   1 BLOCK (coverage)  2 LDB r[a] = input[r[b]]
  3 LDI r[a] = b    4 ALU r[a] = r[b] <c & 7> r[(c >> 3) & 7]
  5 ADDI r[a] = r[b] + c               6 JMP a
  7 BR if r[a] <b & 3> r[(b >> 2) & 7]: pc = c
  8 CRASH           9 LEN r[a] = len   10 LDM r[a] = mem[r[b]]
  11 STM mem[r[a]] = r[b] (out of bounds: crash)

Eight int32 registers, ``mem_size`` int32 cells per lane, arithmetic
wrapping at 32 bits, signed compares, logical SHR, shifts clipped to
0..31.  A BLOCK counts the edge (previous block, this block) in the
program's static edge universe (``compute_edges``) and folds the
block id into the murmur path hash.  A lane still running after
``max_steps`` steps is reported RUNNING (the caller's hang).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FUZZ_NONE, FUZZ_HANG, FUZZ_CRASH, FUZZ_RUNNING, FUZZ_ERROR = 0, 1, 2, 3, 4
MAP_SIZE = 1 << 16
N_REGS = 8
OP_HALT, OP_BLOCK, OP_LDB, OP_LDI, OP_ALU, OP_ADDI, OP_JMP, OP_BR, \
    OP_CRASH, OP_LEN, OP_LDM, OP_STM = range(12)
M32 = 0xFFFFFFFF


class Program(NamedTuple):
    name: str
    instrs: np.ndarray        # int32[NI, 4], BLOCK rows' b = ordinal
    mem_size: int
    max_steps: int
    edge_slot: np.ndarray     # int32[E] AFL map slot of each edge
    edge_table: np.ndarray    # int32[nb + 1, nb] (from + 1, to) -> edge
    map_size: int

    @property
    def n_edges(self) -> int:
        return int(self.edge_slot.shape[0])


def compute_edges(instrs: np.ndarray):
    """The static edge universe: (instrs with each BLOCK's b set to
    its ordinal, edge_from, edge_to, edge_slot, edge_table).  An edge
    (f, t) exists when a path runs from block f's body to block t's
    head without crossing another BLOCK; f = -1 is the entry."""
    ni = instrs.shape[0]
    instrs = instrs.copy()
    block_pcs = [pc for pc in range(ni) if instrs[pc, 0] == OP_BLOCK]
    idx_of_pc = {pc: k for k, pc in enumerate(block_pcs)}
    for k, pc in enumerate(block_pcs):
        instrs[pc, 2] = k
    nb = len(block_pcs)
    ids = [int(instrs[pc, 1]) & (MAP_SIZE - 1) for pc in block_pcs]

    def succs(pc):
        op, a, _b, c = (int(v) for v in instrs[pc])
        if op in (OP_HALT, OP_CRASH):
            return []
        if op == OP_JMP:
            return [a]
        if op == OP_BR:
            return [c, pc + 1]
        return [pc + 1]

    pairs = set()

    def walk(from_idx, start_pc):
        seen = set()
        stack = [start_pc]
        while stack:
            pc = stack.pop()
            if pc in seen or pc < 0 or pc >= ni:
                continue
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
    edge_from = np.array([f for f, _ in order], dtype=np.int32)
    edge_to = np.array([t for _, t in order], dtype=np.int32)
    slot = [ids[t] ^ (0 if f < 0 else ids[f] >> 1) for f, t in order]
    table = np.full((nb + 1, max(nb, 1)), e, dtype=np.int32)
    for k, (f, t) in enumerate(order):
        table[f + 1, t] = k
    return instrs, edge_from, edge_to, np.array(slot, dtype=np.int64), table


def load_program(path: str) -> Program:
    """A program from its frozen ``.npz`` (the instructions, the
    name, ``mem_size``, ``max_steps`` and the module ranges); every
    table is worked out here from the instructions."""
    with np.load(path, allow_pickle=False) as d:
        raw = d["instrs"].astype(np.int32)
        name = str(d["name"])
        mem_size, max_steps = int(d["mem_size"]), int(d["max_steps"])
        modules = list(zip(d["modules_lo"].tolist(),
                           d["modules_hi"].tolist())) or [(0, 1 << 30)]
    instrs, _f, edge_to, slot, table = compute_edges(raw)
    # an edge lands in the map of its destination block's module
    mod_of_block = np.zeros(max(int(edge_to.max(initial=0)) + 1, 1),
                            dtype=np.int64)
    for m, (lo, hi) in enumerate(modules):
        mod_of_block[lo:hi] = m
    slot = slot + (mod_of_block[edge_to] * MAP_SIZE if len(edge_to) else 0)
    return Program(name, instrs, mem_size, max_steps,
                   slot.astype(np.int32), table, len(modules) * MAP_SIZE)


class VMOut(NamedTuple):
    status: torch.Tensor      # int32[B] FUZZ_NONE / CRASH / RUNNING
    exit_code: torch.Tensor   # int32[B]
    counts: torch.Tensor      # uint8[B, E+1] wrapping edge counts
    steps: torch.Tensor       # int32[B]
    path_hash: torch.Tensor   # int64[B] holding uint32


def wrap32(x):
    return ((x + (1 << 31)) & M32) - (1 << 31)


def mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def step(instrs, edge_table, inputs, lengths, mem_size, state):
    """One step of every lane in ``state`` = (pc, regs [B, 9], mem [B,
    mem_size + 1], status, exit_code, prev_idx, counts [B, E+1],
    path_hash, steps), all int64; the last column of regs and mem is
    a sink for writes that do not happen.  Lanes not running change
    nothing.  regs, mem and counts update in place."""
    pc, regs, mem, status, exit_code, prev_idx, counts, path_hash, \
        lane_steps = state
    ni = instrs.shape[0]
    L = inputs.shape[1]
    nb = edge_table.shape[1]
    running = status == FUZZ_RUNNING
    op, a, b, c = instrs[pc.clamp(0, ni - 1)].unbind(1)

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
    shift = ry.clamp(0, 31)
    alu = (rb + ry, rb - ry, rb & ry, rb | ry, rb ^ ry,
           (rb & M32) << shift, (rb & M32) >> shift, rb * ry)
    alu_val = torch.zeros_like(rb)
    for sel, val in enumerate(alu):
        alu_val = torch.where(alu_sel == sel, val, alu_val)
    alu_val = wrap32(alu_val)
    taken = torch.where(
        cmp_sel == 0, ra == cmp_y,
        torch.where(cmp_sel == 1, ra != cmp_y,
                    torch.where(cmp_sel == 2, ra < cmp_y, ra >= cmp_y)))

    mem_ok_ld = (rb >= 0) & (rb < mem_size)
    ldm_val = mem.gather(1, rb.clamp(0, mem_size - 1)[:, None])[:, 0]
    ldm_val = torch.where(mem_ok_ld, ldm_val, 0)
    mem_ok_st = (ra >= 0) & (ra < mem_size)

    new_pc = torch.where(op == OP_JMP, a,
                         torch.where((op == OP_BR) & taken, c, pc + 1))
    wr_val = torch.zeros_like(pc)
    for o, val in ((OP_LDB, ldb_val), (OP_LDI, b), (OP_ALU, alu_val),
                   (OP_ADDI, wrap32(rb + c)), (OP_LEN, lengths),
                   (OP_LDM, ldm_val)):
        wr_val = torch.where(op == o, val, wr_val)
    writes = ((op == OP_LDB) | (op == OP_LDI) | (op == OP_ALU)
              | (op == OP_ADDI) | (op == OP_LEN) | (op == OP_LDM))
    regs.scatter_(1, torch.where(writes & running, a.clamp(0, N_REGS - 1),
                                 N_REGS)[:, None], wr_val[:, None])
    store = (op == OP_STM) & mem_ok_st & running
    mem.scatter_(1, torch.where(store, ra.clamp(0, mem_size - 1),
                                mem_size)[:, None], rb[:, None])

    crashes = ((op == OP_CRASH) | ((op == OP_LDM) & ~mem_ok_ld)
               | ((op == OP_STM) & ~mem_ok_st) | (pc < 0) | (pc >= ni))
    halts = op == OP_HALT
    new_status = torch.where(crashes, FUZZ_CRASH,
                             torch.where(halts, FUZZ_NONE, status))
    new_exit = torch.where(halts & running, a, exit_code)

    is_block = (op == OP_BLOCK) & running
    cur_loc = a & (MAP_SIZE - 1)
    cur_idx = b.clamp(0, nb - 1)
    eidx = edge_table[prev_idx, cur_idx]
    counts.scatter_add_(1, eidx[:, None],
                        is_block.to(counts.dtype)[:, None])
    new_prev = torch.where(is_block, cur_idx + 1, prev_idx)
    new_hash = torch.where(is_block, mix32(path_hash ^ cur_loc), path_hash)
    return (torch.where(running, new_pc, pc), regs, mem,
            torch.where(running, new_status, status),
            torch.where(running, new_exit, exit_code), new_prev, counts,
            new_hash, lane_steps + running.to(lane_steps.dtype))


def run(prog: Program, inputs: torch.Tensor, lengths: torch.Tensor,
        max_steps: int = 0) -> VMOut:
    """Every lane of a uint8[B, L] batch to halt, crash or the step
    budget (``max_steps``, default the program's).  Every 16 steps the
    lanes that stopped are written out and dropped from the step."""
    dev = inputs.device
    b = inputs.shape[0]
    n_edges = prog.n_edges
    max_steps = max_steps or prog.max_steps
    mem_size = prog.mem_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    out = VMOut(torch.full((b,), FUZZ_RUNNING, dtype=torch.int32,
                           device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev),
                torch.zeros((b, n_edges + 1), dtype=torch.uint8,
                            device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev), zeros(b))
    state = (zeros(b), zeros(b, N_REGS + 1), zeros(b, mem_size + 1),
             torch.full((b,), FUZZ_RUNNING, dtype=torch.int64, device=dev),
             zeros(b), zeros(b), zeros(b, n_edges + 1), zeros(b), zeros(b))
    instrs = torch.as_tensor(prog.instrs, device=dev).to(torch.int64)
    table = torch.as_tensor(prog.edge_table, device=dev).to(torch.int64)
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
                                          lengths[running], lanes[running])
        state = step(instrs, table, inputs, lengths, mem_size, state)
    if lanes.numel():
        retire(torch.ones(lanes.shape[0], dtype=torch.bool, device=dev))
    return out
