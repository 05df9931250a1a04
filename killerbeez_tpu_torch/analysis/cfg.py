"""Control-flow graph reconstruction from a KBVM instruction array.

The coverage blocks (OP_BLOCK instructions) are the CFG nodes; block
``-1`` is the program entry (pc 0 runs until the first OP_BLOCK).
Successors come from the instruction semantics — OP_JMP's target,
OP_BR's target + fallthrough, OP_HALT/OP_CRASH terminate, everything
else falls through — the same walk ``vm.compute_edges`` uses to
enumerate the static edge universe, extended with per-edge step costs
so ``max_steps`` can be validated against real (loop-free) paths.

Step accounting matches the engine exactly: every executed
instruction is one step (``lane_steps`` in ``vm._step_batched``),
including the OP_BLOCK marker, the terminal HALT/CRASH, and the step
in which an out-of-range pc is detected.

All walks are iterative (no recursion-limit games) and polynomial:
costs come from a longest-path DP over the cycle-cut graph; only when
cycle cutting finds retreating edges (irreducible regions, whose
loop-free paths CAN use them) does a budget-capped exact path search
refine the result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..models.vm import OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP

ENTRY = -1  # virtual entry node (prev_loc == 0 before the first block)

#: edge-visit budget for the exact path-search refinements on
#: irreducible graphs (exponential worst case; real programs finish
#: in microseconds — the budget is a runaway backstop, and on
#: exhaustion the DP lower bound stands)
_PATH_SEARCH_BUDGET = 2_000_000


def instr_successors(instrs: np.ndarray, pc: int) -> List[int]:
    """Successor pcs of one instruction (out-of-range pcs included —
    the engine crashes the lane on the NEXT step's fetch)."""
    op, a, b, c = (int(x) for x in instrs[pc])
    if op in (OP_HALT, OP_CRASH):
        return []
    if op == OP_JMP:
        return [a]
    if op == OP_BR:
        return [c, pc + 1]
    return [pc + 1]


@dataclass
class ControlFlowGraph:
    """Block-level CFG of one Program (node ``ENTRY`` = entry path).

    ``succ[f]`` holds destination block indices; ``edge_cost[(f, t)]``
    is the maximum number of VM steps spent from f's block head
    (inclusive) to t's block head (exclusive) along any pc-acyclic
    path; ``term_cost[f]`` is the maximum steps from f's head through
    a terminal (HALT/CRASH/off-end), or None when no block-free path
    from f terminates.
    """

    n_blocks: int
    block_pcs: List[int]
    succ: Dict[int, Set[int]]
    edge_cost: Dict[Tuple[int, int], int]
    term_cost: Dict[int, Optional[int]]
    reachable: Set[int]
    dominators: Dict[int, Set[int]] = field(default_factory=dict)
    loop_headers: Set[int] = field(default_factory=set)
    back_edges: Set[Tuple[int, int]] = field(default_factory=set)
    #: longest loop-free complete path (entry -> terminal) in VM
    #: steps — the hang budget must cover at least this much
    longest_acyclic_path: int = 0

    @property
    def edges(self) -> List[Tuple[int, int]]:
        return sorted((f, t) for f, ts in self.succ.items() for t in ts)

    def unreachable_blocks(self) -> List[int]:
        return [k for k in range(self.n_blocks) if k not in self.reachable]


def _classify_edges(graph: Dict[int, List[int]],
                    roots: Iterable[int]):
    """Iterative DFS edge classification: returns ``(retreating
    edges, post-order)``.  Removing the retreating edges makes the
    graph acyclic (any cycle contains one in any DFS)."""
    color: Dict[int, int] = {}          # absent/0 white, 1 gray, 2 black
    retreating: Set[Tuple[int, int]] = set()
    order: List[int] = []
    for root in roots:
        if color.get(root, 0):
            continue
        color[root] = 1
        stack = [(root, iter(graph.get(root, ())))]
        while stack:
            n, it = stack[-1]
            pushed = False
            for t in it:
                c = color.get(t, 0)
                if c == 1:
                    retreating.add((n, t))
                elif c == 0:
                    color[t] = 1
                    stack.append((t, iter(graph.get(t, ()))))
                    pushed = True
                    break
            if not pushed:
                color[n] = 2
                order.append(n)
                stack.pop()
    return retreating, order


def _region_walk(instrs: np.ndarray, start_pc: int,
                 idx_of_pc: Dict[int, int], skip_start: bool):
    """Max-step walk from ``start_pc`` stopping at block heads.

    Returns ``(to_blocks, term)``: ``to_blocks[t]`` = max steps from
    start_pc (inclusive) to block t's head (exclusive); ``term`` = max
    steps through a terminal, or None if no block-free path from here
    terminates.  ``skip_start`` executes through the start pc even
    when it is itself a block head (a block region starts AT its own
    marker; a later branch back to it is a self-edge).

    Costs are a longest-path DP over the region's cycle-cut pc graph
    (linear — reconverging branch diamonds are fine); when the region
    is irreducible (retreating pc edges a loop-free path could still
    take) a budget-capped exact search refines the DP lower bound.
    """
    ni = instrs.shape[0]

    def is_head(pc: int) -> bool:
        return int(instrs[pc, 0]) == OP_BLOCK

    if not skip_start and is_head(start_pc):
        # the entry region ends immediately: pc 0 IS a block head
        return {idx_of_pc[start_pc]: 0}, None

    # -- discover the region: interior pcs + sink/terminal edges ------
    interior_succ: Dict[int, List[int]] = {}
    heads_of: Dict[int, List[int]] = {}     # pc -> block sinks entered
    halt_at: Set[int] = set()               # pc executes HALT/CRASH
    bad_from: Set[int] = set()              # pc has an off-range succ
    stack = [start_pc]
    seen = {start_pc}
    while stack:
        pc = stack.pop()
        succs = instr_successors(instrs, pc)
        if not succs:
            halt_at.add(pc)
        interior = []
        for s in succs:
            if s < 0 or s >= ni:
                bad_from.add(pc)
            elif is_head(s):
                heads_of.setdefault(pc, []).append(idx_of_pc[s])
            else:
                interior.append(s)
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        interior_succ[pc] = interior

    to_blocks: Dict[int, int] = {}
    term: Optional[int] = None

    def apply(pc: int, d: int) -> None:
        """Fold one arrival at ``pc`` with ``d`` instructions already
        executed into the sink costs."""
        nonlocal term
        if pc in halt_at:               # the HALT/CRASH step itself
            term = max(term or 0, d + 1)
        if pc in bad_from:              # executed pc, crashed on fetch
            term = max(term or 0, d + 2)
        for h in heads_of.get(pc, ()):
            if d + 1 > to_blocks.get(h, -1):
                to_blocks[h] = d + 1

    # -- longest-path DP over the cycle-cut region ---------------------
    retreating, order = _classify_edges(interior_succ, [start_pc])
    dist: Dict[int, int] = {start_pc: 0}
    for n in reversed(order):           # reverse post-order = topo
        if n not in dist:
            continue
        apply(n, dist[n])
        for t in interior_succ[n]:
            if (n, t) in retreating:
                continue
            if dist[n] + 1 > dist.get(t, -1):
                dist[t] = dist[n] + 1

    # -- irreducible region: exact (budgeted) refinement ---------------
    if retreating:
        budget = _PATH_SEARCH_BUDGET
        on_path = {start_pc}
        pstack = [(start_pc, iter(interior_succ[start_pc]))]
        apply(start_pc, 0)
        while pstack and budget > 0:
            n, it = pstack[-1]
            moved = False
            for t in it:
                budget -= 1
                if t in on_path:
                    continue
                apply(t, len(pstack))
                on_path.add(t)
                pstack.append((t, iter(interior_succ[t])))
                moved = True
                break
            if not moved:
                pstack.pop()
                on_path.discard(n)

    return to_blocks, term


def _dominators(succ: Dict[int, Set[int]], reachable: Set[int]
                ) -> Dict[int, Set[int]]:
    """Iterative dominator sets over the entry-reachable subgraph
    (``dom[n]`` includes ``n`` and ``ENTRY``)."""
    nodes = [ENTRY] + sorted(reachable)
    node_set = set(nodes)
    preds: Dict[int, Set[int]] = {n: set() for n in nodes}
    for f, ts in succ.items():
        if f not in node_set:
            continue
        for t in ts:
            if t in preds:
                preds[t].add(f)
    dom: Dict[int, Set[int]] = {n: set(nodes) for n in nodes}
    dom[ENTRY] = {ENTRY}
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n == ENTRY:
                continue
            ps = [dom[p] for p in preds[n]]
            new = set.intersection(*ps) if ps else set()
            new = new | {n}
            if new != dom[n]:
                dom[n] = new
                changed = True
    return dom


def _longest_simple_path(graph: Dict[int, List[int]],
                         edge_cost: Dict[Tuple[int, int], int],
                         term_cost: Dict[int, Optional[int]]) -> int:
    """Exact longest block-simple path from ENTRY to a terminal —
    the irreducible-CFG fallback (a DAG longest-path after dropping
    retreating edges would UNDERCOUNT: loop-free executions can take
    a retreating edge whose target they have not visited).  Budgeted;
    iterative."""
    budget = _PATH_SEARCH_BUDGET
    t0 = term_cost.get(ENTRY)
    longest = t0 if t0 is not None else 0
    on_path = {ENTRY}
    stack = [(ENTRY, 0, iter(graph.get(ENTRY, ())))]
    while stack and budget > 0:
        n, d, it = stack[-1]
        moved = False
        for s in it:
            budget -= 1
            if s in on_path:
                continue
            nd = d + edge_cost[(n, s)]
            tc = term_cost.get(s)
            if tc is not None:
                longest = max(longest, nd + tc)
            on_path.add(s)
            stack.append((s, nd, iter(graph.get(s, ()))))
            moved = True
            break
        if not moved:
            stack.pop()
            on_path.discard(n)
    return longest


def build_cfg(program) -> ControlFlowGraph:
    """Reconstruct the block-level CFG of a ``Program``."""
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    block_pcs = [pc for pc in range(ni)
                 if int(instrs[pc, 0]) == OP_BLOCK]
    idx_of_pc = {pc: k for k, pc in enumerate(block_pcs)}
    nb = len(block_pcs)

    succ: Dict[int, Set[int]] = {}
    edge_cost: Dict[Tuple[int, int], int] = {}
    term_cost: Dict[int, Optional[int]] = {}
    starts = [(ENTRY, 0)] if ni else [(ENTRY, -1)]
    starts += [(k, pc) for k, pc in enumerate(block_pcs)]
    for f, start_pc in starts:
        if start_pc < 0:                # empty program: entry crashes
            succ[f] = set()
            term_cost[f] = 1
            continue
        to_blocks, term = _region_walk(instrs, start_pc, idx_of_pc,
                                       skip_start=(f != ENTRY))
        succ[f] = set(to_blocks)
        term_cost[f] = term
        for t, cost in to_blocks.items():
            edge_cost[(f, t)] = cost

    reachable = _reachable_from_entry(succ)
    dom = _dominators(succ, reachable)

    # natural back edges: target dominates source (self-loops always)
    back = {(f, t) for (f, t) in edge_cost
            if f != ENTRY and f in reachable and t in reachable
            and (t == f or t in dom.get(f, ()))}
    headers = {t for _, t in back}

    # loop-free longest path: drop natural back edges (acyclic
    # executions never take one — the target dominates, hence already
    # preceded, the source) and longest-path the remainder.  A
    # reducible CFG is then a DAG; irreducible leftovers (blocks
    # branching into each other with neither dominating) are handled
    # by an EXACT bounded path search, because a loop-free execution
    # CAN traverse a retreating edge it hasn't visited yet.
    dag: Dict[int, List[int]] = {
        f: sorted(t for t in ts if (f, t) not in back)
        for f, ts in succ.items()}
    retreating, order = _classify_edges(dag, [ENTRY] + sorted(dag))
    if retreating:
        longest = _longest_simple_path(dag, edge_cost, term_cost)
    else:
        dist: Dict[int, int] = {ENTRY: 0}
        longest = 0
        for n in reversed(order):       # reverse post-order = topo
            if n not in dist:
                continue                # not reachable from entry
            d = dist[n]
            t_c = term_cost.get(n)
            if t_c is not None:
                longest = max(longest, d + t_c)
            for t in dag.get(n, ()):
                nd = d + edge_cost[(n, t)]
                if nd > dist.get(t, -1):
                    dist[t] = nd

    return ControlFlowGraph(
        n_blocks=nb, block_pcs=block_pcs, succ=succ,
        edge_cost=edge_cost, term_cost=term_cost, reachable=reachable,
        dominators=dom, loop_headers=headers,
        back_edges=back | retreating, longest_acyclic_path=longest)


def _reachable_from_entry(succ: Dict[int, Set[int]]) -> Set[int]:
    seen: Set[int] = set()
    stack = [ENTRY]
    while stack:
        n = stack.pop()
        for t in succ.get(n, ()):
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return seen


def static_edge_prior(program, cfg: Optional[ControlFlowGraph] = None
                      ) -> Dict[int, float]:
    """Static edge-frequency prior, keyed by AFL map SLOT (the
    coverage-signature vocabulary): probability mass reaching each
    edge when every branch is a coin flip, flowed over the loop-free
    CFG.  Rare edges (deep behind many branches) get small mass — the
    cold-start stand-in for FairFuzz's dynamic corpus hit counts.
    Colliding slots sum their mass (aliased edges are already
    indistinguishable to a signature)."""
    cfg = cfg or build_cfg(program)
    dag: Dict[int, List[int]] = {
        f: sorted(t for t in ts if (f, t) not in cfg.back_edges)
        for f, ts in cfg.succ.items()}
    _, order = _classify_edges(dag, [ENTRY] + sorted(dag))

    prob: Dict[int, float] = {ENTRY: 1.0}
    edge_prob: Dict[Tuple[int, int], float] = {}
    for f in reversed(order):           # topological over the DAG
        if f not in prob:
            continue
        ts = cfg.succ.get(f, ())
        if not ts:
            continue
        share = prob[f] / len(ts)
        for t in ts:
            # back edges receive their share too (loops run OFTEN —
            # they must not read as statically rare) but do not
            # propagate mass, keeping the flow well-founded
            edge_prob[(f, t)] = max(edge_prob.get((f, t), 0.0), share)
            if (f, t) not in cfg.back_edges:
                prob[t] = prob.get(t, 0.0) + share

    slots = np.asarray(program.edge_slot)
    ef = np.asarray(program.edge_from)
    et = np.asarray(program.edge_to)
    out: Dict[int, float] = {}
    for i in range(len(slots)):
        p = edge_prob.get((int(ef[i]), int(et[i])), 0.0)
        s = int(slots[i])
        out[s] = out.get(s, 0.0) + p
    return out
