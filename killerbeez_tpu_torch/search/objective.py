"""Branch-distance objectives for the gradient-guided search tier.

Given a frontier edge ``(from_block, to_block)`` of the static
universe, find the branches that DECIDE it: the OP_BRs inside the
source block's body (the instruction region between block f's head
and the next BLOCK instructions) from which the target block's head
is reachable through exactly one successor.  Each deciding branch
yields a :class:`BranchObjective` — the static arguments of the
distance-returning execute variant (``vm.run_batch_distance``), with
the comparison canonicalized so distance 0 always means "the branch
goes the way the edge needs" (want the fall-through -> negate the
compare: eq<->ne, lt<->ge, Angora's distance table direction).

Objectives are ordered shallowest-first (BFS depth from the block
head): on a multi-guard path every deciding branch must go the right
way, and a deeper guard's distance is only observable once the lanes
pass the shallower ones — the descent engine satisfies them in
program order, carrying its population from guard to guard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np

from ..models.vm import (
    CMP_EQ, CMP_GE, CMP_LT, CMP_NE, N_REGS,
    OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP,
)
from ..analysis.dataflow import CMP_NAMES

#: compare negation: "branch NOT taken on <sel>" == "taken on NEG[sel]"
NEG_CMP = {CMP_EQ: CMP_NE, CMP_NE: CMP_EQ, CMP_LT: CMP_GE,
           CMP_GE: CMP_LT}


@dataclass(frozen=True)
class BranchObjective:
    """Static arguments of one branch-distance objective."""
    edge: Tuple[int, int]
    branch_pc: int
    #: canonical compare: distance 0 <=> the edge's successor runs
    sel: int
    x_idx: int              # register index of the left operand
    y_idx: int              # register index of the right operand
    want_taken: bool        # which successor the edge needs
    desc: str

    def dist_kwargs(self) -> Dict[str, int]:
        """Keyword arguments for ``vm.run_batch_distance``."""
        return {"branch_pc": self.branch_pc, "from_idx": self.edge[0],
                "sel": self.sel, "x_idx": self.x_idx,
                "y_idx": self.y_idx}

    def spec(self) -> Tuple[int, int, int, int, int]:
        """The static spec row for ``vm.run_batch_distances``."""
        return (self.branch_pc, self.edge[0], self.sel, self.x_idx,
                self.y_idx)


def _succs(rows, pc: int) -> List[int]:
    op, a, b, c = rows[pc]
    if op in (OP_HALT, OP_CRASH):
        return []
    if op == OP_JMP:
        return [a]
    if op == OP_BR:
        return [c, pc + 1]
    return [pc + 1]


def _block_region(rows, ni: int, start: int
                  ) -> Tuple[Set[int], Dict[int, int]]:
    """(pcs reachable from ``start`` without executing another BLOCK,
    BFS depth of each) — the same stop-at-BLOCK walk that defines the
    static edge universe (``vm.compute_edges``)."""
    depth = {}
    frontier = [start]
    d = 0
    while frontier:
        nxt = []
        for pc in frontier:
            if pc in depth or not (0 <= pc < ni):
                continue
            depth[pc] = d
            if rows[pc][0] == OP_BLOCK:
                continue            # region boundary: don't expand
            nxt.extend(_succs(rows, pc))
        frontier = nxt
        d += 1
    return set(depth), depth


def _reaches_head(rows, ni: int, start: int, t_head: int) -> bool:
    """True when the stop-at-BLOCK walk from ``start`` can execute
    ``t_head`` as its first BLOCK instruction — i.e. entering the
    region at ``start`` can still traverse the (f, t) edge."""
    seen: Set[int] = set()
    stack = [start]
    while stack:
        pc = stack.pop()
        if pc in seen or not (0 <= pc < ni):
            continue
        seen.add(pc)
        if rows[pc][0] == OP_BLOCK:
            if pc == t_head:
                return True
            continue
        stack.extend(_succs(rows, pc))
    return False


def edge_objectives(program, edge: Tuple[int, int]
                    ) -> List[BranchObjective]:
    """Deciding-branch objectives for ``edge``, program order
    (shallowest-first).  Empty
    when the edge is outside the static universe or its source block
    reaches the target unconditionally (covering the source block
    then covers the edge for free — nothing to descend on)."""
    f_idx, t_idx = int(edge[0]), int(edge[1])
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]
    block_pcs = [pc for pc in range(ni) if rows[pc][0] == OP_BLOCK]
    if not (0 <= t_idx < len(block_pcs)) or \
            not (-1 <= f_idx < len(block_pcs)):
        return []
    t_head = block_pcs[t_idx]
    start = 0 if f_idx < 0 else block_pcs[f_idx] + 1
    region, depth = _block_region(rows, ni, start)

    out: List[BranchObjective] = []
    for pc in region:
        if rows[pc][0] != OP_BR:
            continue
        _op, a, b, c = rows[pc]
        taken_ok = _reaches_head(rows, ni, c, t_head)
        fall_ok = _reaches_head(rows, ni, pc + 1, t_head)
        if taken_ok == fall_ok:
            continue                # off-path, or both sides survive
        sel = b & 3
        canon = sel if taken_ok else NEG_CMP[sel]
        x_idx = min(max(a, 0), N_REGS - 1)
        y_idx = (b >> 2) & (N_REGS - 1)
        out.append(BranchObjective(
            edge=(f_idx, t_idx), branch_pc=pc, sel=canon,
            x_idx=x_idx, y_idx=y_idx, want_taken=taken_ok,
            desc=(f"pc {pc}: r{x_idx} {CMP_NAMES[canon]} r{y_idx} "
                  f"({'taken' if taken_ok else 'fall-through'} -> "
                  f"block {t_idx})")))
    out.sort(key=lambda o: depth.get(o.branch_pc, 0))
    return out
