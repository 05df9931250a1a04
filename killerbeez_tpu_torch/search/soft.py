"""Soft-KBVM: a true gradient through a float32-relaxed path slice.

The descent engine's default moves are black-box (finite-difference
probes + evolution strategies).  When the concrete path from entry to
the objective branch is ARITHMETIC-ONLY — every executed op is one of
BLOCK / LDB / LDI / ADDI / LEN / JMP / BR or an ALU add/sub/mul, with
no memory traffic and no bit-twiddling — that path slice has an exact
float32 relaxation: freeze the control flow and the byte-load indices
recorded from one concrete execution, replay the slice as a float
computation over the input-byte vector, and differentiate the branch
distance with ``torch.autograd``.  The gradient proposes whole
multi-byte steps a coordinate prober would need many dispatches to
find.

The replay is a scalar computation of tens of nodes over one input,
so it runs on the host, on a float32 CPU tensor, like the numpy
analysis modules it sits beside: it is host-side work by design, not
a fallback from the card, and its output only PROPOSES candidates
that the card then scores.

Honesty contract: the relaxation only PROPOSES candidates.  Every
proposal re-enters the concrete engine (and, before emission, the
reference interpreter) exactly like an ES mutant — a wrong gradient
costs a wasted lane, never a wrong witness.  Eligibility is decided
from the executed trace itself (the executed ops ARE the path, so the
check is a proof for that path); ``analysis/dataflow.py`` branch
facts additionally narrow the differentiated dimensions to the bytes
the comparison can actually read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.dataflow import _alu_const, _fold_cmp
from ..models.vm import (
    ALU_ADD, ALU_MUL, ALU_SUB, CMP_EQ, CMP_GE, CMP_LT, CMP_NE, N_REGS,
    OP_ADDI, OP_ALU, OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP,
    OP_LDB, OP_LDI, OP_LDM, OP_LEN, OP_STM,
)
from .objective import BranchObjective

#: gradient step sizes tried per refinement, in byte units
_STEP_SCALES = (1.0, 4.0, 16.0, 64.0)


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _r(field: int) -> int:
    return min(max(field, 0), N_REGS - 1)


@dataclass
class SoftSlice:
    """One concrete execution's path slice up to the objective branch:
    the executed (pc, concrete LDB index) records plus eligibility.
    ``ldb_index`` is -1 for non-LDB steps; the final state's branch
    operands are recomputed by the float replay, not stored.
    ``reached`` distinguishes "stopped at the branch" (deps and
    relaxation are meaningful) from "path ended/crashed first"."""
    steps: List[Tuple[int, int]]
    eligible: bool
    reason: str = ""
    reached: bool = False


def trace_slice(program, data: bytes, obj: BranchObjective) -> SoftSlice:
    """Replay ``data`` concretely (lockstep with ``vm._step``
    semantics) up to the first execution of the objective branch with
    the edge's source block as last block; record the executed pcs and
    every LDB's concrete index, and judge arithmetic-only
    eligibility.  Ineligible slices keep exact integer semantics all
    the way, so the verdict is truthful even past the first
    disqualifying op."""
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]
    mem = [0] * int(program.mem_size)
    regs = [0] * N_REGS
    L = len(data)
    pc, last_block, steps = 0, -1, 0
    rec: List[Tuple[int, int]] = []
    eligible = True
    reason = ""
    while steps < int(program.max_steps):
        steps += 1
        if not (0 <= pc < ni):
            return SoftSlice(rec, False, "path crashes before branch")
        if pc == obj.branch_pc and last_block == obj.edge[0]:
            return SoftSlice(rec, eligible, reason, reached=True)
        cur = pc
        op, a, b, c = rows[pc]
        idx = -1
        if op == OP_BLOCK:
            last_block = b
            pc += 1
        elif op == OP_LDB:
            idx = regs[_r(b)]
            regs[_r(a)] = data[idx] if 0 <= idx < L else 0
            pc += 1
        elif op == OP_LDI:
            regs[_r(a)] = _i32(b)
            pc += 1
        elif op == OP_ALU:
            sel = c & 7
            x, y = regs[_r(b)], regs[(c >> 3) & (N_REGS - 1)]
            regs[_r(a)] = _alu_const(sel, x, y)
            if sel not in (ALU_ADD, ALU_SUB, ALU_MUL) and eligible:
                eligible, reason = False, \
                    f"non-arithmetic ALU op at pc {pc}"
            pc += 1
        elif op == OP_ADDI:
            regs[_r(a)] = _i32(regs[_r(b)] + c)
            pc += 1
        elif op == OP_LEN:
            regs[_r(a)] = L
            pc += 1
        elif op == OP_JMP:
            pc = a
        elif op == OP_BR:
            x = regs[_r(a)]
            y = regs[(b >> 2) & (N_REGS - 1)]
            pc = c if _fold_cmp(b & 3, x, y) else pc + 1
        elif op in (OP_LDM, OP_STM):
            if eligible:
                eligible, reason = False, f"memory op at pc {pc}"
            i = regs[_r(b if op == OP_LDM else a)]
            if not (0 <= i < program.mem_size):
                return SoftSlice(rec, False,
                                 "path crashes before branch")
            if op == OP_LDM:
                regs[_r(a)] = mem[i]
            else:
                mem[i] = regs[_r(b)]
            pc += 1
        elif op in (OP_HALT, OP_CRASH):
            return SoftSlice(rec, False, "path ends before branch")
        else:
            pc += 1
        rec.append((cur, idx))
    return SoftSlice(rec, False, "step budget before branch")


def slice_operand_deps(program, sl: SoftSlice,
                       obj: BranchObjective) -> List[int]:
    """Input-byte positions the objective branch's operands depend on
    along the traced path — Angora's dynamic byte-level taint, read
    off the recorded slice instead of a shadow runtime.  Memory is a
    single summary set (over-approximate), which is fine for its one
    consumer: probe prioritization, never correctness."""
    if not sl.reached:
        return []
    instrs = np.asarray(program.instrs)
    rows = [tuple(int(x) for x in instrs[pc])
            for pc in range(instrs.shape[0])]
    deps = [set() for _ in range(N_REGS)]
    mem_deps: set = set()
    for pc, idx in sl.steps:
        op, a, b, c = rows[pc]
        if op == OP_LDB:
            deps[_r(a)] = {idx} if idx >= 0 else set()
        elif op in (OP_LDI, OP_LEN):
            deps[_r(a)] = set()
        elif op == OP_ALU:
            deps[_r(a)] = deps[_r(b)] | deps[(c >> 3) & (N_REGS - 1)]
        elif op == OP_ADDI:
            deps[_r(a)] = set(deps[_r(b)])
        elif op == OP_LDM:
            deps[_r(a)] = set(mem_deps)
        elif op == OP_STM:
            mem_deps |= deps[_r(b)]
    return sorted(deps[obj.x_idx] | deps[obj.y_idx])


def _f32(v) -> torch.Tensor:
    """A float32 constant, rounded once from the exact value (as
    ``jnp.float32(v)`` rounds it)."""
    return torch.tensor(np.float32(v))


def _soft_distance(program, sl: SoftSlice, obj: BranchObjective,
                   length: int):
    """Build the differentiable ``float32[L] -> distance`` replay of
    an eligible slice.  Control flow and load indices are FROZEN from
    the recorded trace; register values are float32 closures over the
    input vector.  The distance relaxes the exact table smoothly:
    eq -> (x-y)^2, ne -> 1/(1+(x-y)^2), lt/ge -> softplus-free
    hinges (relu keeps the descent direction exact where it counts;
    ``torch.maximum`` splits a tie's gradient in half, as JAX does).
    """
    instrs = np.asarray(program.instrs)
    rows = [tuple(int(x) for x in instrs[pc])
            for pc in range(instrs.shape[0])]
    zero = _f32(0.0)

    def dist(x):
        regs = [zero] * N_REGS
        for pc, idx in sl.steps:
            op, a, b, c = rows[pc]
            if op == OP_LDB:
                regs[_r(a)] = x[idx] if 0 <= idx < length else zero
            elif op == OP_LDI:
                regs[_r(a)] = _f32(_i32(b))
            elif op == OP_ALU:
                sel = c & 7
                u, v = regs[_r(b)], regs[(c >> 3) & (N_REGS - 1)]
                regs[_r(a)] = (u + v if sel == ALU_ADD else
                               u - v if sel == ALU_SUB else u * v)
            elif op == OP_ADDI:
                regs[_r(a)] = regs[_r(b)] + _f32(c)
            elif op == OP_LEN:
                regs[_r(a)] = _f32(length)
            # BLOCK / JMP / BR: control flow frozen by the trace
        # the loop above leaves regs as of branch entry
        u, v = regs[obj.x_idx], regs[obj.y_idx]
        d = u - v
        if obj.sel == CMP_EQ:
            return d * d
        if obj.sel == CMP_NE:
            return 1.0 / (1.0 + d * d)
        if obj.sel == CMP_LT:
            return torch.maximum(d + 1.0, zero)
        return torch.maximum(-d, zero)     # CMP_GE

    return dist


def soft_gradient(program, sl: SoftSlice, obj: BranchObjective,
                  data: bytes) -> np.ndarray:
    """d(relaxed distance)/d(input bytes) at ``data``: float32[L]."""
    dist = _soft_distance(program, sl, obj, len(data))
    x0 = torch.tensor(np.frombuffer(data, dtype=np.uint8)
                      .astype(np.float32), requires_grad=True)
    out = dist(x0)
    if not out.requires_grad:      # the slice never read the input
        return np.zeros(len(data), dtype=np.float32)
    (g,) = torch.autograd.grad(out, x0, allow_unused=True)
    if g is None:
        return np.zeros(len(data), dtype=np.float32)
    return g.numpy()


def soft_refine(program, data: bytes, obj: BranchObjective,
                positions: Optional[Sequence[int]] = None,
                slice_: Optional[SoftSlice] = None) -> List[bytes]:
    """Gradient-refinement proposals for ``data`` against the
    objective: trace the path slice, bail (empty list) unless it is
    arithmetic-only, then take one gradient of the relaxed distance
    and emit rounded byte candidates at several step scales, moved
    only along ``positions`` (default: every byte the trace actually
    loaded).  Proposals are CANDIDATES for the concrete engine, never
    emitted as witnesses."""
    sl = slice_ if slice_ is not None else trace_slice(program, data,
                                                       obj)
    if not sl.eligible:
        return []
    L = len(data)
    if positions is None:
        positions = sorted({i for _pc, i in sl.steps
                            if 0 <= i < L})
    positions = [p for p in positions if 0 <= p < L]
    if not positions:
        return []
    g = soft_gradient(program, sl, obj, data)
    if not np.isfinite(g).any() or not np.abs(g[positions]).max():
        return []
    mask = np.zeros(L, dtype=np.float32)
    mask[positions] = 1.0
    g = g * mask
    gmax = np.abs(g).max()
    out: List[bytes] = []
    base = np.frombuffer(data, dtype=np.uint8).astype(np.float32)
    for scale in _STEP_SCALES:
        step = np.clip(np.round(base - g * (scale / gmax)), 0, 255)
        cand = step.astype(np.uint8).tobytes()
        if cand != data:
            out.append(cand)
    return out
