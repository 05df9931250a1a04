"""Static protocol-state analysis — which abstract states can a
session ever reach?

A stateful target's protocol state machine is encoded in the program
text: constants ASSIGNED to the state register (``LDI r7, s`` —
transitions) and constants COMPARED against it (``BR eq r7, rK`` —
guards).  Because the dataflow layer already proves blocks dead under
single-shot constant propagation, the multi-message reachability
question reduces to a fixpoint over per-state single-shot analyses:

    reached = {0}                       # sessions start in state 0
    repeat:
      for s in reached:
        analyze the program with the state register INITIALLY s
        (one prepended LDI; jump targets shift by one) — every
        state-constant assignment in a block live under that
        analysis is a reachable transition target
    until no new state appears

The result powers three surfaces:

  * kb-lint's ``state-unreachable`` check — a state the program
    guards on (or assigns) that NO session can reach from the
    initial state is dead protocol surface, almost certainly a bug
    in the target's state machine;
  * the downgrade of single-shot ``dead-block`` warnings to
    ``session-only-block`` info for blocks a session CAN light
    (the whole point of the tier — they are not dead weight);
  * the session half of the deep-edge story: single-shot
    unreachability is certified by
    ``models.targets_stateful.deep_state_blocks`` + the solver, and
    ``session_reachable_blocks`` here is how a session CAN light
    those same blocks.

Copied from the JAX package (host numpy).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from ..models.vm import (
    N_REGS, OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP, OP_LDI,
    Program,
)
from . import StatefulSpec

#: fixpoint safety valve: more distinct states than this and the
#: analysis reports what it found so far (never loops unbounded)
MAX_TRACKED_STATES = 64


def with_initial_state(program: Program, state_reg: int,
                       value: int) -> Program:
    """A copy of ``program`` whose state register starts at ``value``:
    one ``LDI`` prepended at pc 0, every JMP/BR target shifted by
    one.  Block ordinals are unchanged, so dead-block sets compare
    directly against the original program's."""
    instrs = np.asarray(program.instrs).copy()
    for pc in range(instrs.shape[0]):
        op = int(instrs[pc, 0])
        if op == OP_JMP:
            instrs[pc, 1] += 1
        elif op == OP_BR:
            instrs[pc, 3] += 1
    pre = np.array([[OP_LDI, state_reg, int(value), 0]],
                   dtype=np.int32)
    return Program(instrs=np.concatenate([pre, instrs]),
                   name=f"{program.name}@s{value}",
                   mem_size=program.mem_size,
                   max_steps=program.max_steps)


def state_assignments(program: Program,
                      state_reg: int) -> List[Tuple[int, int]]:
    """(pc, value) for every ``LDI state_reg, value`` row."""
    instrs = np.asarray(program.instrs)
    return [(pc, int(instrs[pc, 2]))
            for pc in range(instrs.shape[0])
            if int(instrs[pc, 0]) == OP_LDI
            and int(instrs[pc, 1]) == state_reg]


def state_compares(program: Program, state_reg: int) -> Set[int]:
    """Constants the program compares the state register against —
    guard states.  Resolves the non-state operand by scanning back
    through the straight-line run before the branch for its LDI
    (the idiom every handler uses: ``ldi rK, s; br eq r7, rK``)."""
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]

    def const_of(reg: int, from_pc: int):
        for pc in range(from_pc - 1, -1, -1):
            op, a, b, c = (int(v) for v in instrs[pc])
            if op in (OP_JMP, OP_BR, OP_HALT, OP_CRASH, OP_BLOCK):
                return None          # left the straight-line run
            if op == OP_LDI and a == reg:
                return b
            if op in (2, 4, 5, 9, 10) and a == reg:
                return None          # reg rewritten non-constantly
        return None

    out: Set[int] = set()
    for pc in range(ni):
        if int(instrs[pc, 0]) != OP_BR:
            continue
        ra = int(instrs[pc, 1])
        rb = (int(instrs[pc, 2]) >> 2) & (N_REGS - 1)
        if ra == state_reg:
            c = const_of(rb, pc)
            if c is not None:
                out.add(c)
        elif rb == state_reg:
            c = const_of(ra, pc)
            if c is not None:
                out.add(c)
    return out


def _block_of_pc(program: Program, pc: int) -> int:
    """Ordinal of the coverage block containing ``pc`` (-1 = the
    entry region before the first BLOCK)."""
    instrs = np.asarray(program.instrs)
    block = -1
    for p in range(min(pc, instrs.shape[0] - 1) + 1):
        if int(instrs[p, 0]) == OP_BLOCK:
            block += 1
    return block


def reachable_states(program: Program, spec: StatefulSpec
                     ) -> Tuple[Set[int], Dict[int, Set[int]]]:
    """The fixpoint: (states reachable from 0 across messages,
    {state: blocks live when a message starts in it})."""
    from ..analysis import analyze_dataflow, build_cfg
    assigns = state_assignments(program, spec.state_reg)
    reached: Set[int] = {0}
    live_by_state: Dict[int, Set[int]] = {}
    frontier = [0]
    while frontier and len(reached) <= MAX_TRACKED_STATES:
        s = frontier.pop()
        ps = with_initial_state(program, spec.state_reg, s)
        cfg = build_cfg(ps)
        df = analyze_dataflow(ps)
        live = set(cfg.reachable) - set(df.dead_blocks)
        live_by_state[s] = live
        for pc, v in assigns:
            blk = _block_of_pc(program, pc)
            if (blk == -1 or blk in live) and v not in reached:
                reached.add(v)
                frontier.append(v)
    return reached, live_by_state


def session_reachable_blocks(program: Program,
                             spec: StatefulSpec) -> Set[int]:
    """Blocks some session (any reachable state at message entry)
    can light — the union kb-lint's dead-block downgrade consumes
    (lint_program computes it inline from reachable_states to share
    one fixpoint run; this is the standalone spelling)."""
    _, live = reachable_states(program, spec)
    out: Set[int] = set()
    for blocks in live.values():
        out |= blocks
    return out


def declared_states(program: Program, spec: StatefulSpec) -> Set[int]:
    """Every state constant the program mentions (assignments and
    guards) — the vocabulary the reachability check audits."""
    return ({v for _, v in state_assignments(program, spec.state_reg)}
            | state_compares(program, spec.state_reg))


def unreachable_states(program: Program, spec: StatefulSpec,
                       _reached: Set[int] = None) -> List[int]:
    """Declared states no session reaches from the initial state —
    kb-lint's ``state-unreachable`` payload (initial state 0 is
    always reachable; negative guard constants are sentinels, not
    states, and are ignored).  ``_reached`` lets lint_program reuse
    its fixpoint result instead of re-running it."""
    if _reached is None:
        _reached, _ = reachable_states(program, spec)
    return sorted(v for v in declared_states(program, spec)
                  if v >= 0 and v not in _reached)
