"""Abstract interpretation over the KBVM's 8-register ISA.

Two cheap analyses run in one fixpoint over the instruction graph:

* **constant propagation** — registers start at 0 and most target
  code builds compare operands with OP_LDI/OP_ADDI, so branch
  operands are very often statically known;
* **input-byte taint** — OP_LDB introduces taint (the set of input
  byte indices a value may depend on); OP_ALU/OP_ADDI propagate it;
  stores fold it into a single memory-summary taint set.

The combination yields exactly what byte-level guidance needs
statically: for each OP_BR, *which input bytes* the comparison
depends on and *which constant* guards it.  Angora buys this with
dynamic taint tracking at significant runtime cost (PAPERS.md); the
KBVM tier reads it off the program text.  Downstream consumers:

* ``extract_dictionary`` — branch-comparison constants as an
  automatic dictionary for the ``dictionary`` mutator (magic bytes,
  opcode bytes, length fields), with runs of consecutive
  single-byte-position compares merged into multi-byte tokens
  (``expect_byte`` chains become whole magic strings);
* lint — statically-dead blocks (CFG-reachable but unreachable once
  constants fold branches) and must-crash blocks (every path from
  the block head crashes: OP_CRASH, or LDM/STM with a known
  out-of-bounds index).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from ..models.vm import (
    ALU_ADD, ALU_AND, ALU_MUL, ALU_OR, ALU_SHL, ALU_SHR, ALU_SUB,
    ALU_XOR, CMP_EQ, CMP_GE, CMP_LT, CMP_NE, N_REGS,
    OP_ALU, OP_ADDI, OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP,
    OP_LDB, OP_LDI, OP_LDM, OP_LEN, OP_STM,
)
from .cfg import instr_successors

CMP_NAMES = {CMP_EQ: "eq", CMP_NE: "ne", CMP_LT: "lt", CMP_GE: "ge"}

#: taint lattice top: "may depend on any input byte"
ANY = None

#: internal taint marker for OP_LEN results ("depends on the input
#: LENGTH, not on any byte value").  It rides the same frozensets as
#: byte indices during the fixpoint but is STRIPPED before facts are
#: published: ``BranchFact.deps`` still names byte positions only
#: (every downstream consumer — focus masks, dictionary runs, the
#: solver — indexes buffers with them), and the length dependency
#: surfaces as ``BranchFact.len_dep`` for the grammar auto-deriver.
_LEN_TAINT = -1

# an abstract register value: (const, taint)
#   const: int (known exact value) or None (unknown)
#   taint: frozenset of input byte indices, or ANY (= None)
_ZERO = (0, frozenset())
_UNKNOWN = (None, ANY)


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _reg(field: int) -> int:
    """Direct register fields follow the engine's ``jnp.clip(field,
    0, N_REGS - 1)``; packed subfields (ALU's rb, BR's cmp rb) are
    masked at extraction instead — matching vm._step exactly keeps
    analysis facts true even for malformed programs."""
    return min(max(field, 0), N_REGS - 1)


def _alu_const(sel: int, x: int, y: int) -> Optional[int]:
    """Exact int32 semantics of vm._step's ALU select."""
    ux, uy = x & 0xFFFFFFFF, y & 0xFFFFFFFF
    if sel == ALU_ADD:
        return _i32(x + y)
    if sel == ALU_SUB:
        return _i32(x - y)
    if sel == ALU_AND:
        return _i32(ux & uy)
    if sel == ALU_OR:
        return _i32(ux | uy)
    if sel == ALU_XOR:
        return _i32(ux ^ uy)
    s = min(max(y, 0), 31)
    if sel == ALU_SHL:
        return _i32(ux << s)
    if sel == ALU_SHR:
        return _i32(ux >> s)
    if sel == ALU_MUL:
        return _i32(x * y)
    return None


def _join_taint(a, b):
    if a is ANY or b is ANY:
        return ANY
    return a | b


def _join_val(a, b):
    const = a[0] if a[0] == b[0] else None
    return (const, _join_taint(a[1], b[1]))


def _join_state(a, b):
    if a is None:
        return b
    regs = tuple(_join_val(x, y) for x, y in zip(a[0], b[0]))
    return (regs, _join_taint(a[1], b[1]))


@dataclass(frozen=True)
class BranchFact:
    """One OP_BR as the abstract interpreter saw it."""
    pc: int
    block: int                      # nearest preceding block (-1 = entry)
    cmp: str                        # eq / ne / lt / ge
    #: comparison constant guarding the branch, when one side is a
    #: known constant and the other side is input-tainted
    const: Optional[int]
    #: input byte indices the comparison may depend on (ANY = unknown)
    deps: Optional[FrozenSet[int]]
    #: statically decided outcome (both sides constant), else None
    always: Optional[bool]
    #: True when the comparison may depend on the input LENGTH
    #: (OP_LEN taint) — the grammar auto-deriver's length-field
    #: signal; byte-position consumers keep reading ``deps``
    len_dep: bool = False


@dataclass
class DataflowResult:
    branches: List[BranchFact]
    reached_pcs: Set[int]
    #: blocks the CFG can reach but constant folding proves dead
    dead_blocks: Set[int] = field(default_factory=set)
    #: blocks from whose head EVERY path crashes
    must_crash_blocks: Set[int] = field(default_factory=set)
    #: pcs that crash unconditionally when executed (OP_CRASH, or a
    #: memory op with a known out-of-bounds index)
    crash_pcs: Set[int] = field(default_factory=set)


def analyze_dataflow(program) -> DataflowResult:
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    mem_size = int(program.mem_size)
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]

    # nearest preceding OP_BLOCK, for human-facing reports
    block_of_pc: List[int] = []
    cur = -1
    for pc in range(ni):
        if rows[pc][0] == OP_BLOCK:
            cur += 1
        block_of_pc.append(cur)

    state_in: Dict[int, tuple] = {}
    worklist: List[int] = []
    if ni:
        state_in[0] = (tuple(_ZERO for _ in range(N_REGS)), frozenset())
        worklist.append(0)

    def flow(pc: int, st: tuple) -> None:
        prev = state_in.get(pc)
        joined = _join_state(prev, st)
        if joined != prev:
            state_in[pc] = joined
            worklist.append(pc)

    def transfer(pc: int, st: tuple):
        """Returns [(succ_pc, out_state)] for in-range successors."""
        regs, mem_taint = st
        op, a, b, c = rows[pc]
        out_regs = list(regs)
        if op == OP_LDB:
            idx_c, idx_t = regs[_reg(b)]
            if idx_c is not None and idx_c < 0:
                out_regs[_reg(a)] = (0, frozenset())
            else:
                taint = frozenset([idx_c]) if idx_c is not None else ANY
                out_regs[_reg(a)] = \
                    (None, _join_taint(taint, idx_t))
        elif op == OP_LDI:
            out_regs[_reg(a)] = (_i32(b), frozenset())
        elif op == OP_ALU:
            sel = c & 7
            xc, xt = regs[_reg(b)]
            yc, yt = regs[(c >> 3) & (N_REGS - 1)]
            const = _alu_const(sel, xc, yc) \
                if xc is not None and yc is not None else None
            out_regs[_reg(a)] = (const, _join_taint(xt, yt))
        elif op == OP_ADDI:
            xc, xt = regs[_reg(b)]
            const = _i32(xc + c) if xc is not None else None
            out_regs[_reg(a)] = (const, xt)
        elif op == OP_LEN:
            out_regs[_reg(a)] = (None, frozenset({_LEN_TAINT}))
        elif op == OP_LDM:
            out_regs[_reg(a)] = (None, mem_taint)
        elif op == OP_STM:
            mem_taint = _join_taint(mem_taint,
                                    regs[_reg(b)][1])
        new_st = (tuple(out_regs), mem_taint)

        if op == OP_BR:
            xc, _ = regs[_reg(a)]
            yc, _ = regs[(b >> 2) & (N_REGS - 1)]
            taken = _fold_cmp(b & 3, xc, yc)
            succs = instr_successors(instrs, pc)  # [target, pc + 1]
            if taken is True:
                succs = succs[:1]
            elif taken is False:
                succs = succs[1:]
            return [(s, new_st) for s in succs if 0 <= s < ni]
        return [(s, new_st) for s in instr_successors(instrs, pc)
                if 0 <= s < ni]

    while worklist:
        pc = worklist.pop()
        for s, out in transfer(pc, state_in[pc]):
            flow(s, out)

    # -- branch facts over the final in-states ------------------------
    branches: List[BranchFact] = []
    for pc in sorted(state_in):
        op, a, b, c = rows[pc]
        if op != OP_BR:
            continue
        regs, _ = state_in[pc]
        (xc, xt) = regs[_reg(a)]
        (yc, yt) = regs[(b >> 2) & (N_REGS - 1)]
        always = _fold_cmp(b & 3, xc, yc)
        const = None
        if xc is not None and yc is None:
            const = xc
        elif yc is not None and xc is None:
            const = yc
        deps = _join_taint(xt, yt)
        len_dep = False
        if deps is not ANY:
            len_dep = _LEN_TAINT in deps
            deps = frozenset(i for i in deps if i >= 0)
        branches.append(BranchFact(
            pc=pc, block=block_of_pc[pc], cmp=CMP_NAMES[b & 3],
            const=const, deps=deps, always=always, len_dep=len_dep))

    # -- definite-crash pcs (constant-index memory faults) ------------
    crash_pcs: Set[int] = set()
    for pc in sorted(state_in):
        op, a, b, c = rows[pc]
        if op == OP_CRASH:
            crash_pcs.add(pc)
        elif op in (OP_LDM, OP_STM):
            idx_reg = b if op == OP_LDM else a
            idx_c, _ = state_in[pc][0][_reg(idx_reg)]
            if idx_c is not None and not (0 <= idx_c < mem_size):
                crash_pcs.add(pc)
        elif op == OP_JMP and not (0 <= a < ni):
            crash_pcs.add(pc)

    # -- must-crash: least fixpoint over reached pcs ------------------
    # (loops stay False — a pure spin is a hang, not a crash)
    folded_succs: Dict[int, List[int]] = {}
    for pc in state_in:
        succs = [s for s, _ in transfer(pc, state_in[pc])]
        oob = [s for s in instr_successors(instrs, pc)
               if not (0 <= s < ni)]
        folded_succs[pc] = succs + oob
    must = {pc: False for pc in state_in}
    oob_must = True                     # off-end pc always crashes
    changed = True
    while changed:
        changed = False
        for pc in must:
            if must[pc]:
                continue
            if pc in crash_pcs:
                must[pc] = True
                changed = True
                continue
            succs = folded_succs[pc]
            if succs and all(
                    (must.get(s, oob_must) if 0 <= s < ni else True)
                    for s in succs):
                must[pc] = True
                changed = True

    block_pcs = [pc for pc in range(ni) if rows[pc][0] == OP_BLOCK]
    dead = {k for k, pc in enumerate(block_pcs) if pc not in state_in}
    must_blocks = {k for k, pc in enumerate(block_pcs)
                   if must.get(pc, False)}
    return DataflowResult(branches=branches,
                          reached_pcs=set(state_in),
                          dead_blocks=dead,
                          must_crash_blocks=must_blocks,
                          crash_pcs=crash_pcs)


def _fold_cmp(sel: int, x: Optional[int], y: Optional[int]
              ) -> Optional[bool]:
    if x is None or y is None:
        return None
    if sel == CMP_EQ:
        return x == y
    if sel == CMP_NE:
        return x != y
    if sel == CMP_LT:
        return x < y
    return x >= y


def extract_dictionary(program,
                       result: Optional[DataflowResult] = None,
                       max_tokens: int = 256) -> List[bytes]:
    """Branch-comparison constants as dictionary tokens.

    Every input-tainted branch guarded by a known constant donates
    the constant's byte encoding; runs of consecutive single-byte
    positional compares (``expect_byte`` chains: deps == {i}, one
    8-bit constant per position) merge into multi-byte tokens, so a
    magic header like ``"STK1"`` comes out whole.  This is the
    guidance Angora derives from dynamic byte-level taint — free
    here because the program text is ours (PAPERS.md).
    """
    return [tok for _pc, tok in
            dictionary_candidates(program, result,
                                  max_tokens=max_tokens)]


def dictionary_candidates(program,
                          result: Optional[DataflowResult] = None,
                          max_tokens: int = 256
                          ) -> List[Tuple[int, bytes]]:
    """``extract_dictionary`` with provenance: deduped
    ``(first-use pc, token)`` pairs in the same deterministic
    (pc, bytes) order.  The pc anchors message/handler scoping for
    sequence targets (stateful.dictionary.extract_dictionary_groups
    maps it to the guarding protocol state)."""
    result = result or analyze_dataflow(program)
    # (first-use pc, token) candidates; the FINAL order is sorted by
    # (first-use pc, bytes) and deduped — deterministic across runs
    # and across any reordering of the branch list (the order used to
    # follow collection order, so dictionary walks depended on
    # analysis-internal iteration details)
    cands: List[Tuple[int, bytes]] = []

    # positional single-byte compares -> merged runs (the most
    # valuable tokens), collected only when a position pins ONE value
    by_pos: Dict[int, Set[int]] = {}
    first_pc: Dict[int, int] = {}
    for f in result.branches:
        if (f.cmp in ("eq", "ne") and f.const is not None
                and 0 <= f.const <= 255 and f.deps is not ANY
                and f.deps is not None and len(f.deps) == 1):
            i = next(iter(f.deps))
            if isinstance(i, int) and i >= 0:
                by_pos.setdefault(i, set()).add(f.const)
                first_pc[i] = min(first_pc.get(i, f.pc), f.pc)
    run: List[int] = []

    def flush(run: List[int]) -> None:
        if len(run) >= 2:
            cands.append((min(first_pc[i] for i in run),
                          bytes(next(iter(by_pos[i])) for i in run)))

    for i in sorted(by_pos):
        single = len(by_pos[i]) == 1
        if single and run and i == run[-1] + 1:
            run.append(i)
            continue
        flush(run)
        run = [i] if single else []
    flush(run)

    # individual constants (any input-dependent guarded compare)
    for f in result.branches:
        if f.const is None:
            continue
        if f.deps is not ANY and not f.deps:
            continue                    # not input-dependent (e.g. len)
        c = f.const
        if c == 0:
            continue                    # zero bytes carry no signal
        u = c & 0xFFFFFFFF
        if 0 < c <= 0xFF:
            cands.append((f.pc, bytes([c])))
        elif 0 < c <= 0xFFFF:
            cands.append((f.pc, u.to_bytes(2, "little")))
            cands.append((f.pc, u.to_bytes(2, "big")))
        else:
            cands.append((f.pc, u.to_bytes(4, "little")))
            cands.append((f.pc, u.to_bytes(4, "big")))
        # compare-WIDTH little-endian encoding: a multi-byte eq/ne
        # compare (deps = {i..i+w-1}, e.g. a 32-bit field assembled
        # from 4 OP_LDBs) against a SMALL constant needs the wide
        # encoding in the input — value magnitude alone emits only
        # the short form (0x50 compared as a dword must land as
        # 50 00 00 00, never as a lone 0x50).  Endianness of the
        # assembly is unknowable statically; little-endian is the
        # KBVM convention (read_bytes/write_bytes default) and the
        # grammar token alphabets seed from exactly these.
        if (f.cmp in ("eq", "ne") and f.deps is not ANY
                and 2 <= len(f.deps) <= 4 and u < (1 << (8 * len(f.deps)))):
            cands.append((f.pc, u.to_bytes(len(f.deps), "little")))

    tokens: List[Tuple[int, bytes]] = []
    seen: Set[bytes] = set()
    for pc, tok in sorted(cands):
        if tok and tok not in seen:
            seen.add(tok)
            tokens.append((pc, tok))
        if len(tokens) >= max_tokens:
            break
    return tokens[:max_tokens]
