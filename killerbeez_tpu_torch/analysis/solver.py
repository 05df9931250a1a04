"""Path-condition collection and input synthesis over the KBVM.

The static layer (cfg.py / dataflow.py) already *describes* every
branch — which input bytes it reads, which constant guards it.  This
module closes the loop from description to ACTION: given a target
edge of the static universe, walk the instruction graph from entry,
collect the branch conditions a path to that edge must satisfy, and
solve them into a concrete input.  Angora needs dynamic byte-level
taint plus gradient search to do this against opaque binaries
(PAPERS.md); the KBVM tier reads the whole program text, so path
conditions are computed, not inferred.

Exactness tiers (honest by construction):

  * ``expect_byte``-style chains and linear LDI/ADDI/ALU
    compositions over single bytes solve EXACTLY: every constraint
    reduces to a domain filter over one 256-value byte (or the input
    length), evaluated under the engine's int32-wrap semantics.
  * multi-variable conditions (e.g. ``budget = b4 | (b5 << 8)``)
    fall back to budget-capped backtracking enumeration over the
    remaining domains.
  * loop-carried state is explored only up to ``max_visits`` passes
    per pc (default 2 — enough for once-around loop edges and
    two-command state machines); deeper iteration counts, symbolic
    memory indexing and checksum folds come back ``unknown``, never
    guessed.

The honesty guarantee the crack stage relies on: **a solved result
is always concretely verified** — the synthesized input is executed
through ``concrete_run`` (a pure-Python reference interpreter kept
in lockstep with ``vm._step``) and must actually traverse the target
edge before the solver will emit it.  ``unsat`` is only reported
when the edge is outside the static universe or every candidate path
was exhaustively refuted without hitting a budget/visit cap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from .. import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE, FUZZ_RUNNING
from ..models.vm import (
    ALU_ADD, ALU_AND, ALU_MUL, ALU_OR, ALU_SHL, ALU_SHR, ALU_SUB,
    ALU_XOR, N_REGS,
    OP_ADDI, OP_ALU, OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP,
    OP_LDB, OP_LDI, OP_LDM, OP_LEN, OP_STM,
)
from ..models.vm import CMP_EQ, CMP_GE, CMP_LT, CMP_NE
from .cfg import ENTRY, instr_successors
from .dataflow import (
    ANY, CMP_NAMES, DataflowResult, _alu_const, _fold_cmp, _i32, _reg,
    analyze_dataflow,
)

#: DFS state-expansion budget per edge (a Python-side walk; typical
#: magic-byte chains solve in a few hundred expansions — the budget
#: bounds the unsolvable-edge worst case)
DEFAULT_BUDGET = 100_000

#: assignment tries for the multi-variable enumeration fallback
DEFAULT_ENUM_BUDGET = 8_192

#: how many times one pc may appear on a candidate path (2 = one
#: full loop revisit: enough for loop self-edges and two-command
#: interpreter-state machines; raise for deeper protocols)
DEFAULT_MAX_VISITS = 2

#: synthesized inputs are capped at this length unless overridden
DEFAULT_MAX_LEN = 64

#: the input-length variable (shares the byte-variable namespace)
LEN_VAR = ("len", -1)


# --------------------------------------------------------------------
# concrete reference interpreter (lockstep with vm._step)
# --------------------------------------------------------------------

@dataclass
class ConcreteTrace:
    """One scalar execution: verdict + the exact edge/block walk."""
    status: int                 # FUZZ_NONE / FUZZ_CRASH / FUZZ_HANG
    exit_code: int
    steps: int
    edges: List[Tuple[int, int]]    # (from block, to block), -1 = entry
    blocks: List[int]
    #: every OP_BR executed, in order: (pc, x, y, taken) with the
    #: concrete operand values at that step — the conformance pass's
    #: blame-localization evidence (analysis/conformance.py)
    branches: List[Tuple[int, int, int, bool]] = field(
        default_factory=list)


def concrete_run(program, data: bytes) -> ConcreteTrace:
    """Execute ``data`` through the program with exact engine
    semantics (field clips, int32 wraps, OOB LDB -> 0, OOB memory ->
    crash, step budget -> hang).  The solver's proof obligation and
    the dataflow tests' ground truth."""
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]
    mem = [0] * int(program.mem_size)
    regs = [0] * N_REGS
    L = len(data)
    pc, prev = 0, -1
    status, exit_code, steps = FUZZ_RUNNING, 0, 0
    edges: List[Tuple[int, int]] = []
    blocks: List[int] = []
    branches: List[Tuple[int, int, int, bool]] = []
    while status == FUZZ_RUNNING and steps < int(program.max_steps):
        steps += 1
        if pc < 0 or pc >= ni:
            status = FUZZ_CRASH
            break
        op, a, b, c = rows[pc]
        if op == OP_HALT:
            status, exit_code = FUZZ_NONE, a
        elif op == OP_BLOCK:
            edges.append((prev, b))     # b = block ordinal (compute_edges)
            blocks.append(b)
            prev = b
            pc += 1
        elif op == OP_LDB:
            i = regs[_reg(b)]
            regs[_reg(a)] = data[i] if 0 <= i < L else 0
            pc += 1
        elif op == OP_LDI:
            regs[_reg(a)] = _i32(b)
            pc += 1
        elif op == OP_ALU:
            x, y = regs[_reg(b)], regs[(c >> 3) & (N_REGS - 1)]
            regs[_reg(a)] = _alu_const(c & 7, x, y)
            pc += 1
        elif op == OP_ADDI:
            regs[_reg(a)] = _i32(regs[_reg(b)] + c)
            pc += 1
        elif op == OP_JMP:
            pc = a
        elif op == OP_BR:
            x, y = regs[_reg(a)], regs[(b >> 2) & (N_REGS - 1)]
            taken = _fold_cmp(b & 3, x, y)
            branches.append((pc, x, y, bool(taken)))
            pc = c if taken else pc + 1
        elif op == OP_CRASH:
            status = FUZZ_CRASH
        elif op == OP_LEN:
            regs[_reg(a)] = L
            pc += 1
        elif op == OP_LDM:
            i = regs[_reg(b)]
            if not (0 <= i < program.mem_size):
                status = FUZZ_CRASH
            else:
                regs[_reg(a)] = mem[i]
                pc += 1
        elif op == OP_STM:
            i = regs[_reg(a)]
            if not (0 <= i < program.mem_size):
                status = FUZZ_CRASH
            else:
                mem[i] = regs[_reg(b)]
                pc += 1
        else:                           # unknown op: engine falls through
            pc += 1
    if status == FUZZ_RUNNING:
        status = FUZZ_HANG
    return ConcreteTrace(status=status, exit_code=exit_code, steps=steps,
                         edges=edges, blocks=blocks, branches=branches)


# --------------------------------------------------------------------
# symbolic values and constraints
# --------------------------------------------------------------------

class Sym:
    """An abstract register value along ONE path: a closure over the
    input variables it reads (``('byte', i)`` / ``LEN_VAR``), exact
    under int32 wrap.  ``opaque`` marks values the closure tier
    cannot evaluate (symbolic memory indexing) — constraints over
    them defer entirely to concrete verification."""

    __slots__ = ("vars", "opaque", "fn", "desc")

    def __init__(self, vars: FrozenSet, opaque: bool,
                 fn: Optional[Callable], desc: str):
        self.vars = vars
        self.opaque = opaque
        self.fn = fn
        self.desc = desc


def _const(v: int) -> Sym:
    v = _i32(v)
    return Sym(frozenset(), False, lambda env, v=v: v, str(v))


def _varsym(var) -> Sym:
    name = "len" if var == LEN_VAR else f"input[{var[1]}]"
    return Sym(frozenset([var]), False, lambda env, var=var: env[var],
               name)


def _opaque(vars: FrozenSet) -> Sym:
    return Sym(vars, True, None, "?")


_ALU_FNS = {
    ALU_ADD: (lambda x, y: x + y, "+"),
    ALU_SUB: (lambda x, y: x - y, "-"),
    ALU_AND: (lambda x, y: (x & 0xFFFFFFFF) & (y & 0xFFFFFFFF), "&"),
    ALU_OR: (lambda x, y: (x & 0xFFFFFFFF) | (y & 0xFFFFFFFF), "|"),
    ALU_XOR: (lambda x, y: (x & 0xFFFFFFFF) ^ (y & 0xFFFFFFFF), "^"),
    ALU_SHL: (lambda x, y: (x & 0xFFFFFFFF) << min(max(y, 0), 31), "<<"),
    ALU_SHR: (lambda x, y: (x & 0xFFFFFFFF) >> min(max(y, 0), 31), ">>"),
    ALU_MUL: (lambda x, y: x * y, "*"),
}


def _binop(sel: int, x: Sym, y: Sym) -> Sym:
    f, opname = _ALU_FNS[sel]
    if x.opaque or y.opaque:
        return _opaque(x.vars | y.vars)
    if not x.vars and not y.vars:
        return _const(f(x.fn({}), y.fn({})))
    return Sym(x.vars | y.vars, False,
               lambda env, f=f, x=x, y=y: _i32(f(x.fn(env), y.fn(env))),
               f"({x.desc}{opname}{y.desc})")


class Constraint:
    """One path condition: a predicate over input variables that the
    chosen path requires to hold."""

    __slots__ = ("vars", "opaque", "pred", "desc")

    def __init__(self, vars: FrozenSet, opaque: bool,
                 pred: Optional[Callable], desc: str):
        self.vars = vars
        self.opaque = opaque
        self.pred = pred
        self.desc = desc


def _br_constraint(pc: int, sel: int, x: Sym, y: Sym,
                   want: bool) -> Constraint:
    opaque = x.opaque or y.opaque
    pred = None if opaque else (
        lambda env, sel=sel, x=x, y=y, want=want:
        _fold_cmp(sel, x.fn(env), y.fn(env)) is want)
    return Constraint(x.vars | y.vars, opaque, pred,
                      f"pc {pc}: {x.desc} {CMP_NAMES[sel]} {y.desc}"
                      f" is {want}")


def _range_constraint(pc: int, idx: Sym, size: int,
                      what: str) -> Constraint:
    pred = None if idx.opaque else (
        lambda env, idx=idx, size=size: 0 <= idx.fn(env) < size)
    return Constraint(idx.vars, idx.opaque, pred,
                      f"pc {pc}: 0 <= {idx.desc} < {size} ({what})")


def _len_constraint(i: int) -> Constraint:
    return Constraint(frozenset([LEN_VAR]), False,
                      lambda env, i=i: env[LEN_VAR] >= i + 1,
                      f"len >= {i + 1}")


def _add_constraints(new_cs, domains, deferred):
    """Fold constraints into the domain state.  Returns the updated
    ``(domains, deferred)`` or None when provably infeasible.  Fully
    pinned constraints check immediately; single-free-variable
    constraints filter that variable's domain (exact — the domain is
    at most 256 bytes values or the length range); multi-variable and
    opaque constraints defer.  A domain shrink re-queues deferred
    constraints that mention the variable."""
    domains = dict(domains)
    deferred = list(deferred)
    queue = list(new_cs)
    while queue:
        c = queue.pop()
        if c.opaque:
            deferred.append(c)
            continue
        env = {v: next(iter(domains[v])) for v in c.vars
               if len(domains[v]) == 1}
        free = [v for v in c.vars if len(domains[v]) > 1]
        if not free:
            if not c.pred(env):
                return None
            continue
        if len(free) > 1:
            deferred.append(c)
            continue
        v = free[0]
        keep = frozenset(x for x in domains[v]
                         if c.pred({**env, v: x}))
        if not keep:
            return None
        if keep != domains[v]:
            domains[v] = keep
            still = []
            for d in deferred:
                if not d.opaque and v in d.vars:
                    queue.append(d)
                else:
                    still.append(d)
            deferred = still
    return domains, deferred


def _enum_deferred(hard: List[Constraint], domains, budget: int):
    """Backtracking search for an assignment satisfying the deferred
    multi-variable constraints.  Returns the (possibly empty)
    assignment dict, or None when refuted/budget-exhausted; the
    second value reports budget exhaustion."""
    free = sorted({v for c in hard for v in c.vars
                   if len(domains[v]) > 1},
                  key=lambda v: (len(domains[v]), v))
    pinned = {v: next(iter(domains[v]))
              for c in hard for v in c.vars if len(domains[v]) == 1}
    assignment: Dict = {}
    tries = [0]

    def ok() -> bool:
        env = {**pinned, **assignment}
        for c in hard:
            if all(v in env for v in c.vars):
                if not c.pred(env):
                    return False
        return True

    def search(i: int) -> Optional[bool]:
        if tries[0] > budget:
            return None                 # budget bail
        if i == len(free):
            return ok()
        v = free[i]
        for x in sorted(domains[v]):
            tries[0] += 1
            if tries[0] > budget:
                return None
            assignment[v] = x
            if ok():
                r = search(i + 1)
                if r:
                    return r
                if r is None:
                    return None
            assignment.pop(v, None)
        return False

    r = search(0)
    if r is None:
        return None, True
    if not r:
        return None, False
    return dict(assignment), False


# --------------------------------------------------------------------
# the edge solver
# --------------------------------------------------------------------

@dataclass
class SolveResult:
    """Outcome of one edge-cracking attempt.

    ``status``:
      solved   — ``input`` concretely traverses the edge (verified
                 against the reference interpreter; never guessed)
      unsat    — the edge is outside the static universe, or every
                 candidate path was exhaustively refuted
      unknown  — budget / visit-cap / modeling-tier limits; honest
                 "can't tell", NOT "no"
    """
    edge: Tuple[int, int]
    status: str
    input: Optional[bytes] = None
    reason: str = ""
    conditions: List[str] = field(default_factory=list)
    paths_tried: int = 0
    expansions: int = 0
    #: set ONLY by solve_edge_vsa (the --vsa path): seeded byte
    #: domains, escalation ladder, and — on unsat — the exhaustive-
    #: refutation certificate.  None on the default path, so the
    #: no-flag JSON surface stays bit-identical (the parity anchor)
    vsa: Optional[Dict] = None

    def as_dict(self) -> Dict:
        d = {"edge": list(self.edge), "status": self.status,
             "reason": self.reason, "paths_tried": self.paths_tried,
             "expansions": self.expansions}
        if self.input is not None:
            d["input_hex"] = self.input.hex()
            d["length"] = len(self.input)
        if self.conditions:
            d["conditions"] = self.conditions
        if self.vsa is not None:
            d["vsa"] = self.vsa
        return d


def unknown_kind(reason: str) -> str:
    """Stable category of an ``unknown`` reason string — the search
    tier's intake taxonomy, pinned by regression fixtures so a solver
    change that silently reshapes the frontier is caught:

      budget    — the path-search / enumeration budget ran out first
                  (raising --budget may flip the verdict)
      visit-cap — loop-carried state beyond max_visits passes is not
                  modeled (checksum-style loops; raising the cap
                  rarely helps — this is the descent tier's intake)
      model     — the bounded input model intervened (reads forced
                  in-bounds, length capped at max_len)
    """
    if "budget" in reason:
        return "budget"
    if "visit" in reason:
        return "visit-cap"
    if "bounded input model" in reason:
        return "model"
    return "other"


@dataclass
class _State:
    pc: int
    regs: tuple
    mem: Dict[int, Sym]
    mem_havoc: bool
    last_block: int
    steps: int
    visits: Dict[int, int]
    domains: Dict
    deferred: tuple
    conds: tuple


def _instr_reach(instrs, ni: int, target_pc: int) -> Tuple[Set[int],
                                                           Dict[int, int]]:
    """(pcs from which target_pc is reachable, BFS distance to it) —
    the DFS prune and the try-nearer-successors-first ordering.
    Successors come from ``cfg.instr_successors`` (one definition of
    the instruction semantics for cfg/dataflow/solver alike)."""
    preds: Dict[int, List[int]] = {pc: [] for pc in range(ni)}
    for pc in range(ni):
        for s in instr_successors(instrs, pc):
            if 0 <= s < ni:
                preds[s].append(pc)
    dist = {target_pc: 0}
    frontier = [target_pc]
    while frontier:
        nxt = []
        for n in frontier:
            for p in preds[n]:
                if p not in dist:
                    dist[p] = dist[n] + 1
                    nxt.append(p)
        frontier = nxt
    return set(dist), dist


def solve_edge(program, edge: Tuple[int, int], *,
               budget: int = DEFAULT_BUDGET,
               enum_budget: int = DEFAULT_ENUM_BUDGET,
               max_visits: int = DEFAULT_MAX_VISITS,
               max_len: int = DEFAULT_MAX_LEN,
               fill: int = 0,
               vsa_seeds: Optional[Dict] = None) -> SolveResult:
    """Synthesize an input whose execution traverses ``edge``
    (a ``(from_block, to_block)`` pair of the static universe,
    ``-1`` = entry).

    ``vsa_seeds`` (``('byte', i) -> frozenset``) replaces the
    256-value top domain of the named byte variables at creation —
    sound only when every seed is a NECESSARY condition of reaching
    the edge (``vsa_seed_domains`` computes exactly those, from VSA
    guards that instruction-dominate the target with one side forced)
    — a seeded refutation therefore remains exhaustive."""
    f_idx, t_idx = int(edge[0]), int(edge[1])
    pairs = set(zip(np.asarray(program.edge_from).tolist(),
                    np.asarray(program.edge_to).tolist()))
    if (f_idx, t_idx) not in pairs:
        return SolveResult(edge=(f_idx, t_idx), status="unsat",
                           reason="edge not in the static universe")
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]
    block_pcs = [pc for pc in range(ni) if rows[pc][0] == OP_BLOCK]
    t_head = block_pcs[t_idx]
    mem_size = int(program.mem_size)
    max_steps = int(program.max_steps)
    can_reach, dist = _instr_reach(instrs, ni, t_head)
    if 0 not in can_reach:
        return SolveResult(edge=(f_idx, t_idx), status="unsat",
                           reason="target block unreachable from entry")

    init = _State(pc=0, regs=tuple(_const(0) for _ in range(N_REGS)),
                  mem={}, mem_havoc=False, last_block=ENTRY, steps=0,
                  visits={}, domains={LEN_VAR:
                                      frozenset(range(max_len + 1))},
                  deferred=(), conds=())
    stack = [init]
    expansions = paths_tried = 0
    capped = False                      # any visit-cap / budget prune?
    # the model is an UNDER-approximation in two places — LDB reads
    # are modeled in-bounds only (the short-input zero-read
    # alternative is dropped) and the length domain is clipped at
    # max_len (a constraint satisfiable only by longer inputs reads
    # as refuted) — so the moment either is exercised, "exhaustively
    # refuted" can no longer be claimed and unsat degrades to unknown
    restricted = False

    def finalize(st: _State) -> Optional[Tuple[bytes, List[str]]]:
        nonlocal capped
        hard = [c for c in st.deferred if not c.opaque]
        assignment: Dict = {}
        if hard:
            assignment, bailed = _enum_deferred(hard, st.domains,
                                                enum_budget)
            if bailed:
                capped = True
            if assignment is None:
                return None
        env = {v: assignment.get(v, min(dom))
               for v, dom in st.domains.items()}
        byte_vars = [v for v in env if v != LEN_VAR]
        length = env.get(LEN_VAR,
                         max((v[1] + 1 for v in byte_vars), default=1))
        length = max(min(length, max_len), 1)
        data = bytearray([fill & 0xFF]) * length
        for v in byte_vars:
            if 0 <= v[1] < length:
                data[v[1]] = env[v] & 0xFF
        buf = bytes(data)
        trace = concrete_run(program, buf)
        if (f_idx, t_idx) in trace.edges:
            return buf, list(st.conds)
        return None

    while stack:
        if expansions >= budget:
            return SolveResult(
                edge=(f_idx, t_idx), status="unknown",
                reason=f"path-search budget exhausted "
                       f"({budget} expansions)",
                paths_tried=paths_tried, expansions=expansions)
        expansions += 1
        st = stack.pop()
        pc = st.pc
        if pc < 0 or pc >= ni or pc not in can_reach:
            continue                    # crash / cannot reach target
        if st.steps + 1 > max_steps:
            capped = True
            continue
        op, a, b, c = rows[pc]
        # -- target arrival: executing t's head right after block f --
        if op == OP_BLOCK and pc == t_head and st.last_block == f_idx:
            paths_tried += 1
            got = finalize(st)
            if got is not None:
                buf, conds = got
                return SolveResult(edge=(f_idx, t_idx), status="solved",
                                   input=buf, conditions=conds,
                                   paths_tried=paths_tried,
                                   expansions=expansions)
            # extensions past a failed arrival are not explored, so
            # exhaustiveness no longer holds on this subtree
            capped = True
            continue
        if st.visits.get(pc, 0) >= max_visits:
            capped = True
            continue
        st.visits = {**st.visits, pc: st.visits.get(pc, 0) + 1}
        st.steps += 1

        if op == OP_BLOCK:
            st.last_block = b           # ordinal (compute_edges rewrote)
            st.pc = pc + 1
            stack.append(st)
            continue
        if op in (OP_HALT, OP_CRASH):
            continue                    # terminal: target not reached
        if op == OP_JMP:
            st.pc = a
            stack.append(st)
            continue
        if op == OP_BR:
            sel = b & 3
            x = st.regs[_reg(a)]
            y = st.regs[(b >> 2) & (N_REGS - 1)]
            if LEN_VAR in (x.vars | y.vars):
                restricted = True       # length domain capped at
            branches = []               # max_len: not exhaustive
            for want, succ in ((True, c), (False, pc + 1)):
                if not (0 <= succ < ni) or succ not in can_reach:
                    continue
                folded = _add_constraints(
                    [_br_constraint(pc, sel, x, y, want)],
                    st.domains, st.deferred)
                if folded is None:
                    continue
                dom, defer = folded
                cdesc = f"pc {pc}: {x.desc} {CMP_NAMES[sel]} " \
                        f"{y.desc} is {want}"
                branches.append((succ, dom, tuple(defer),
                                 st.conds + (cdesc,)))
            # push farther-from-target first so the nearer branch
            # pops (and solves) first
            branches.sort(key=lambda t: -dist.get(t[0], 1 << 30))
            for succ, dom, defer, conds in branches:
                stack.append(_State(
                    pc=succ, regs=st.regs, mem=dict(st.mem),
                    mem_havoc=st.mem_havoc, last_block=st.last_block,
                    steps=st.steps, visits=dict(st.visits),
                    domains=dom, deferred=defer, conds=conds))
            continue

        # -- straight-line register/memory ops -----------------------
        regs = list(st.regs)
        if op == OP_LDB:
            idx = regs[_reg(b)]
            i = _concrete(idx, st.domains)
            if i is not None:
                if i < 0:
                    regs[_reg(a)] = _const(0)
                elif i > max_len - 1:
                    restricted = True   # would need len > max_len
                    continue
                else:
                    var = ("byte", i)
                    restricted = True   # in-bounds read modeled only
                    if var not in st.domains:
                        dom = frozenset(range(256))
                        if vsa_seeds:
                            dom = vsa_seeds.get(var, dom)
                        st.domains = {**st.domains, var: dom}
                    folded = _add_constraints([_len_constraint(i)],
                                              st.domains, st.deferred)
                    if folded is None:
                        continue
                    st.domains, defer = folded
                    st.deferred = tuple(defer)
                    regs[_reg(a)] = _varsym(var)
            else:
                regs[_reg(a)] = _opaque(idx.vars)
        elif op == OP_LDI:
            regs[_reg(a)] = _const(b)
        elif op == OP_ALU:
            regs[_reg(a)] = _binop(c & 7, regs[_reg(b)],
                                   regs[(c >> 3) & (N_REGS - 1)])
        elif op == OP_ADDI:
            regs[_reg(a)] = _binop(ALU_ADD, regs[_reg(b)], _const(c))
        elif op == OP_LEN:
            regs[_reg(a)] = _varsym(LEN_VAR)
        elif op == OP_LDM:
            idx = regs[_reg(b)]
            i = _concrete(idx, st.domains)
            if i is not None:
                if not (0 <= i < mem_size):
                    continue            # definite crash on this path
                regs[_reg(a)] = (_opaque(frozenset())
                                 if st.mem_havoc
                                 else st.mem.get(i, _const(0)))
            else:
                if LEN_VAR in idx.vars:
                    restricted = True   # length domain capped
                folded = _add_constraints(
                    [_range_constraint(pc, idx, mem_size, "ldm")],
                    st.domains, st.deferred)
                if folded is None:
                    continue
                st.domains, defer = folded
                st.deferred = tuple(defer)
                regs[_reg(a)] = _opaque(idx.vars)
        elif op == OP_STM:
            idx = regs[_reg(a)]
            i = _concrete(idx, st.domains)
            if i is not None:
                if not (0 <= i < mem_size):
                    continue            # definite crash on this path
                st.mem = {**st.mem, i: regs[_reg(b)]}
            else:
                if LEN_VAR in idx.vars:
                    restricted = True   # length domain capped
                folded = _add_constraints(
                    [_range_constraint(pc, idx, mem_size, "stm")],
                    st.domains, st.deferred)
                if folded is None:
                    continue
                st.domains, defer = folded
                st.deferred = tuple(defer)
                st.mem_havoc = True     # unknown cell overwritten
        st.regs = tuple(regs)
        st.pc = pc + 1
        stack.append(st)

    if capped:
        return SolveResult(
            edge=(f_idx, t_idx), status="unknown",
            reason="no satisfiable path within the visit/step caps "
                   "(loop-carried state beyond "
                   f"{max_visits} passes is not modeled)",
            paths_tried=paths_tried, expansions=expansions)
    if restricted:
        return SolveResult(
            edge=(f_idx, t_idx), status="unknown",
            reason="no satisfiable path under the bounded input "
                   "model (reads forced in-bounds, length capped at "
                   f"{max_len} — raise max_len or accept unknown)",
            paths_tried=paths_tried, expansions=expansions)
    return SolveResult(
        edge=(f_idx, t_idx), status="unsat",
        reason="every candidate path exhaustively refuted",
        paths_tried=paths_tried, expansions=expansions)


def _concrete(sym: Sym, domains) -> Optional[int]:
    """The sym's exact value when every variable it reads is pinned
    to a singleton domain, else None."""
    if sym.opaque:
        return None
    if not sym.vars:
        return sym.fn({})
    env = {}
    for v in sym.vars:
        dom = domains.get(v)
        if dom is None or len(dom) != 1:
            return None
        env[v] = next(iter(dom))
    return sym.fn(env)


def solve_edges(program, edges=None, **kw) -> Dict[Tuple[int, int],
                                                   SolveResult]:
    """Solve several edges (default: the whole static universe)."""
    if edges is None:
        edges = list(zip(np.asarray(program.edge_from).tolist(),
                         np.asarray(program.edge_to).tolist()))
    return {(int(f), int(t)): solve_edge(program, (f, t), **kw)
            for f, t in edges}


# --------------------------------------------------------------------
# VSA-seeded solving (the --vsa path; analysis/vsa.py consumer (a))
# --------------------------------------------------------------------

_CMP_BY_NAME = {"eq": CMP_EQ, "ne": CMP_NE, "lt": CMP_LT,
                "ge": CMP_GE}

#: visit-cap escalation ladder tried per edge under --vsa, shallow
#: first.  Soundness: a deeper unroll only ADDS candidate paths, so
#: per-edge take-best is monotone — solved stops the ladder (witness
#: verified), unsat stops it (already exhaustive), unknown escalates.
#: Measured on the gate targets: imgparse 36 -> 51 solved and
#: tlvstack 173 -> 183 at default budgets, rledec saturated at 58.
VSA_VISIT_LADDER = (2, 3, 4)


def _instr_dominators(instrs, ni: int) -> List[int]:
    """Instruction-level dominator sets from pc 0, as bitmasks
    (``doms[p] >> q & 1`` = q dominates p).  Unreached pcs keep the
    all-ones mask (vacuous — never consulted for them)."""
    preds: List[List[int]] = [[] for _ in range(ni)]
    reach = [False] * ni
    if ni:
        reach[0] = True
        frontier = [0]
        while frontier:
            p = frontier.pop()
            for s in instr_successors(instrs, p):
                if 0 <= s < ni:
                    preds[s].append(p)
                    if not reach[s]:
                        reach[s] = True
                        frontier.append(s)
    full = (1 << ni) - 1
    doms = [full] * ni
    if ni:
        doms[0] = 1
    changed = True
    while changed:
        changed = False
        for p in range(1, ni):
            if not reach[p]:
                continue
            m = full
            for q in preds[p]:
                m &= doms[q]
            m |= (1 << p)
            if m != doms[p]:
                doms[p] = m
                changed = True
    return doms


def vsa_seed_domains(program, vsa, edge: Tuple[int, int]
                     ) -> Tuple[Dict, List[Dict]]:
    """Byte-variable seed domains for ``edge``, derived from VSA
    branch facts that are NECESSARY conditions of traversing it:
    guards that (i) instruction-dominate the target block head,
    (ii) have exactly one successor that can still reach it (the
    forced side — taking the other permanently leaves the target's
    reach set), and (iii) carry an exact affine byte provenance
    against a constant, so the forced outcome inverts to a byte set.

    Returns ``(seeds, notes)``: ``('byte', i) -> frozenset`` plus
    one provenance note per contributing guard (the --explain and
    certificate payload).  Contradictory guards (empty intersection)
    drop the seed for that byte rather than claim bottom — the
    short-input zero-read path is outside this argument."""
    from .vsa import affine_sat_set, _side_pred
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]
    block_pcs = [pc for pc in range(ni) if rows[pc][0] == OP_BLOCK]
    t_idx = int(edge[1])
    if not (0 <= t_idx < len(block_pcs)):
        return {}, []
    t_head = block_pcs[t_idx]
    can_reach, _dist = _instr_reach(instrs, ni, t_head)
    doms = _instr_dominators(instrs, ni)
    dom_mask = doms[t_head]

    seeds: Dict = {}
    notes: List[Dict] = []
    for f in vsa.branches:
        p = f.pc
        if not (0 <= p < ni) or not (dom_mask >> p) & 1:
            continue
        _op, _a, b, c = rows[p]
        taken, fall = c, p + 1
        if taken == fall:
            continue                    # degenerate: no forcing
        live = [s for s in (taken, fall)
                if 0 <= s < ni and s in can_reach]
        if len(live) != 1:
            continue
        want = live[0] == taken
        sel = _CMP_BY_NAME[f.cmp]
        for aff, other, is_x in ((f.x_affine, f.y_dom, True),
                                 (f.y_affine, f.x_dom, False)):
            if aff is None or other.const_val is None:
                continue
            trip = _side_pred(sel, other.const_val, want, is_x)
            if trip is None:
                continue
            sat = affine_sat_set(aff, *trip)
            i = aff[0]
            var = ("byte", i)
            cur = seeds.get(var, frozenset(range(256)))
            nxt = cur & sat
            if not nxt:
                # contradictory guards: drop rather than claim
                # bottom (zero-read paths live outside the model)
                seeds.pop(var, None)
                break
            if len(nxt) == 256:
                continue                # guard does not constrain
            seeds[var] = nxt
            notes.append({
                "byte": i, "pc": p, "cmp": f.cmp,
                "const": other.const_val, "forced": bool(want),
                "affine": list(aff), "values": len(nxt)})
            break                       # one side used per guard
    return seeds, notes


def _seed_summary(seeds: Dict, notes: List[Dict],
                  dep_bytes) -> Dict[str, str]:
    """Per-position domain descriptions for --explain: seeded bytes
    name the guard that pruned them; dependency bytes without a seed
    name the honest failure (domain too wide to prune)."""
    out: Dict[str, str] = {}
    by_byte: Dict[int, List[Dict]] = {}
    for n in notes:
        by_byte.setdefault(n["byte"], []).append(n)
    for (kind, i), dom in sorted(seeds.items()):
        ns = by_byte.get(i, [])
        src = ", ".join(f"pc {n['pc']} ({n['cmp']} {n['const']})"
                        for n in ns)
        vals = sorted(dom)
        shown = ",".join(map(str, vals[:8])) + \
            (",…" if len(vals) > 8 else "")
        out[f"byte[{i}]"] = (f"seeded {{{shown}}} "
                             f"({len(vals)} of 256) from forced "
                             f"guard(s) {src}")
    for i in sorted(dep_bytes or []):
        key = f"byte[{i}]"
        if key not in out:
            out[key] = ("[0,255] — no dominating forced guard "
                        "constrains this position (interval too "
                        "wide to prune)")
    return out


def solve_edge_vsa(program, edge: Tuple[int, int], *, vsa=None,
                   budget: int = DEFAULT_BUDGET,
                   enum_budget: int = DEFAULT_ENUM_BUDGET,
                   max_visits: int = DEFAULT_MAX_VISITS,
                   max_len: int = DEFAULT_MAX_LEN,
                   fill: int = 0,
                   dataflow: Optional[DataflowResult] = None
                   ) -> SolveResult:
    """``solve_edge`` with VSA assistance: byte domains seed from
    the edge's dominating forced guards instead of top, and honest
    visit-cap unknowns escalate through ``VSA_VISIT_LADDER`` —
    deeper unrolls only ever ADD candidate paths, so the first
    solved (always concretely witness-verified) or unsat (already
    exhaustive at that rung) verdict stands, and an edge the ladder
    cannot settle stays an honest unknown carrying the domains that
    were too wide (``SolveResult.vsa['domains']``).

    The default-flag path never calls this function: no-flag
    behavior is bit-identical to ``solve_edge`` (the parity
    anchor)."""
    from .vsa import analyze_vsa
    if vsa is None:
        vsa = analyze_vsa(program)
    seeds, notes = vsa_seed_domains(program, vsa, edge)

    ladder = [v for v in VSA_VISIT_LADDER if v >= max_visits] \
        or [max_visits]
    if ladder[0] != max_visits and max_visits not in ladder:
        ladder = [max_visits] + ladder
    best: Optional[SolveResult] = None
    tried: List[int] = []
    for mv in ladder:
        res = solve_edge(program, edge, budget=budget,
                         enum_budget=enum_budget, max_visits=mv,
                         max_len=max_len, fill=fill,
                         vsa_seeds=seeds or None)
        tried.append(mv)
        best = res
        if res.status in ("solved", "unsat"):
            break
        if unknown_kind(res.reason) != "visit-cap":
            break                       # deeper unrolls cannot help

    meta: Dict = {
        "seeded_bytes": sorted(n["byte"] for n in notes),
        "seeds": {f"byte[{n['byte']}]": n for n in notes},
        "visit_ladder": tried,
    }
    if best.status == "unsat":
        # the exhaustive-refutation certificate: no caps were hit at
        # this rung (solve_edge only says unsat when capped and
        # restricted both stayed False), and every seed narrowed a
        # NECESSARY condition — so the refutation covers the full
        # input space
        meta["certificate"] = {
            "exhaustive": True, "max_visits": tried[-1],
            "expansions": best.expansions,
            "paths_tried": best.paths_tried,
            "forced_guards": notes,
        }
    if best.status == "unknown":
        if dataflow is None:
            dataflow = analyze_dataflow(program)
        dep = edge_dep_mask(program, [edge], dataflow)
        meta["domains"] = _seed_summary(seeds, notes, dep)
    best.vsa = meta
    return best


def edge_dep_mask(program, edges,
                  dataflow: Optional[DataflowResult] = None
                  ) -> Optional[List[int]]:
    """Byte positions the frontier ``edges`` depend on: the union of
    the input-byte dependency sets of every branch inside the SOURCE
    block of each edge (those branches decide which out-edge runs).
    Returns a sorted position list, or None when nothing usable is
    known (a branch with unknown deps contributes nothing — the mask
    must never exclude bytes an uncovered branch might read, so an
    all-unknown frontier disables focusing rather than guessing)."""
    dataflow = dataflow or analyze_dataflow(program)
    by_block: Dict[int, object] = {}
    for fct in dataflow.branches:
        cur = by_block.get(fct.block, frozenset())
        if cur is ANY:
            continue
        by_block[fct.block] = (ANY if fct.deps is ANY
                               else cur | fct.deps)
    missing = object()                  # ANY is None: distinguish a
    mask: Set[int] = set()              # branch-free source block
    any_unknown = False                 # (one out-edge, nothing to
    for f, _t in edges:                 # focus) from unknown deps
        deps = by_block.get(int(f), missing)
        if deps is ANY:
            any_unknown = True
        elif deps is not missing and deps:
            mask |= set(deps)
    if any_unknown or not mask:
        return None
    return sorted(mask)
