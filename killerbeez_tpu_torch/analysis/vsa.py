"""Value-set analysis — a strided-interval abstract interpretation.

The constant-propagation fixpoint (dataflow.py) answers "is this
operand a known constant?"; everything else is top.  This second
fixpoint answers the much richer question Angora buys with dynamic
byte-level tracking (PAPERS.md, arxiv 1803.01307 / 1711.04596):
*which values* can each register — and each input-byte position —
take at each pc.  The domain is a reduced product of

  * a **small value set** (≤ ``SET_CAP`` concrete int32 values —
    exact, transfers run elementwise through ``_alu_const``), and
  * a **strided interval** ``lo + k*stride ⊆ [lo, hi]`` once a set
    overflows (sound over-approximation; transfers mirror
    ``vm._step``'s int32 wrap/clip semantics and go to TOP rather
    than model a wrap they cannot bound).

Alongside the domain every register carries an **affine byte
provenance** ``value == scale*byte[i] + offset`` (kept only while
provably wrap-free and identical across joined paths) — the handle
that lets a guard like ``b0 + 200 == 300`` be inverted back to the
byte domain ``b0 = 100`` exactly, which neither constprop (constant
300 is not a byte) nor the solver's per-path closures (they never
summarize across paths) surface statically.

Honesty contract (the same discipline as solver.py): every published
domain is an OVER-approximation of the concrete collecting
semantics, checkable by concrete replay — ``check_replay`` executes
an input through ``concrete_run`` and verifies every executed
branch's operands lie inside the branch's published domains and the
taken side was marked feasible.  Widening points (``WIDEN_AFTER``
joins per pc) and the single-cell memory summary are the two
deliberate imprecisions; both only ever widen, never narrow.

Consumers: solver seeding (``forced_byte_domains`` — see
solver.solve_edge_vsa), grammar derivation (grammar/derive.py
``vsa=``), value priors (analysis/priors.py), and the lint checks
``infeasible-edge`` / ``value-range-contradiction`` /
``guaranteed-oob-store`` (lint.py ``vsa=``).
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from ..models.vm import (
    ALU_ADD, ALU_AND, ALU_MUL, ALU_OR, ALU_SHL, ALU_SHR, ALU_SUB,
    ALU_XOR, N_REGS,
    OP_ADDI, OP_ALU, OP_BLOCK, OP_BR, OP_CRASH, OP_HALT, OP_JMP,
    OP_LDB, OP_LDI, OP_LDM, OP_LEN, OP_STM,
)
from .cfg import instr_successors
from .dataflow import CMP_NAMES, _alu_const, _fold_cmp, _i32, _reg

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1

#: small-value-set cap: beyond this many concrete values the domain
#: degrades to its strided-interval hull (16 matches the grammar
#: tier's alphabet cap — a position compared against more values is
#: a dispatch byte, not magic)
SET_CAP = 16

#: joins tolerated per pc before the moving interval bound widens to
#: the int32 extreme (the fixpoint's termination lever; byte domains
#: live in [0, 255] and never need it)
WIDEN_AFTER = 8

#: fixpoint iteration backstop (runaway guard, far above any real
#: program — the widening above is what actually bounds the chain)
_MAX_ITERS = 200_000

#: sidecar / checkpoint-section schema tag
VSA_SCHEMA = "kbz-vsa-v1"


def _gcd(a: int, b: int) -> int:
    return math.gcd(abs(a), abs(b))


# --------------------------------------------------------------------
# the value domain
# --------------------------------------------------------------------

@dataclass(frozen=True)
class VDom:
    """One abstract int32 value: ``vals`` (exact small set) when not
    None, else the strided interval ``{lo + k*stride} ∩ [lo, hi]``
    (``stride == 0`` means the singleton ``lo``)."""
    lo: int
    hi: int
    stride: int
    vals: Optional[FrozenSet[int]] = None

    # -- constructors -------------------------------------------------

    @staticmethod
    def top() -> "VDom":
        return _TOP

    @staticmethod
    def const(v: int) -> "VDom":
        v = _i32(v)
        return VDom(v, v, 0, frozenset((v,)))

    @staticmethod
    def from_vals(vs) -> "VDom":
        vs = frozenset(_i32(v) for v in vs)
        if not vs:
            raise ValueError("empty value set has no VDom")
        if len(vs) > SET_CAP:
            return VDom._hull(vs)
        lo, hi = min(vs), max(vs)
        return VDom(lo, hi, _set_stride(vs), vs)

    @staticmethod
    def _hull(vs) -> "VDom":
        lo, hi = min(vs), max(vs)
        return VDom(lo, hi, _set_stride(vs) if lo != hi else 0)

    @staticmethod
    def range(lo: int, hi: int, stride: int = 1) -> "VDom":
        lo, hi = max(lo, INT32_MIN), min(hi, INT32_MAX)
        if lo > hi:
            raise ValueError("empty interval has no VDom")
        if lo == hi:
            return VDom.const(lo)
        n = (hi - lo) // max(stride, 1) + 1
        if n <= SET_CAP:
            return VDom.from_vals(
                range(lo, hi + 1, max(stride, 1)))
        return VDom(lo, hi, max(stride, 1))

    # -- predicates ---------------------------------------------------

    @property
    def is_top(self) -> bool:
        return (self.vals is None and self.lo == INT32_MIN
                and self.hi == INT32_MAX and self.stride == 1)

    @property
    def is_const(self) -> bool:
        return self.lo == self.hi

    @property
    def const_val(self) -> Optional[int]:
        return self.lo if self.lo == self.hi else None

    def contains(self, v: int) -> bool:
        if self.vals is not None:
            return v in self.vals
        if not (self.lo <= v <= self.hi):
            return False
        return self.stride == 0 or (v - self.lo) % self.stride == 0

    def count(self) -> int:
        """How many concrete values the domain admits."""
        if self.vals is not None:
            return len(self.vals)
        if self.stride == 0:
            return 1
        return (self.hi - self.lo) // self.stride + 1

    def enum(self, cap: int = 256) -> Optional[List[int]]:
        """The concrete values, when there are at most ``cap``."""
        if self.count() > cap:
            return None
        if self.vals is not None:
            return sorted(self.vals)
        return list(range(self.lo, self.hi + 1, max(self.stride, 1)))

    # -- lattice ------------------------------------------------------

    def join(self, other: "VDom") -> "VDom":
        if self == other:
            return self
        if self.vals is not None and other.vals is not None:
            u = self.vals | other.vals
            if len(u) <= SET_CAP:
                return VDom.from_vals(u)
        lo, hi = min(self.lo, other.lo), max(self.hi, other.hi)
        s = _gcd(self.stride, other.stride)
        s = _gcd(s, abs(self.lo - other.lo))
        if lo == hi:
            return VDom.const(lo)
        return VDom(lo, hi, max(s, 1))

    def widen(self, newer: "VDom") -> "VDom":
        """Classic interval widening: a moving bound jumps to the
        int32 extreme; the stride collapses to 1 (documented
        imprecision — strides rarely survive loop-carried updates
        anyway)."""
        j = self.join(newer)
        if j == self:
            return self
        lo = self.lo if j.lo >= self.lo else INT32_MIN
        hi = self.hi if j.hi <= self.hi else INT32_MAX
        if lo == INT32_MIN and hi == INT32_MAX:
            return _TOP
        return VDom(lo, hi, 1 if lo != hi else 0)

    def as_doc(self) -> Dict:
        d: Dict = {"lo": int(self.lo), "hi": int(self.hi),
                   "stride": int(self.stride)}
        if self.vals is not None:
            d["vals"] = sorted(int(v) for v in self.vals)
        return d

    @staticmethod
    def from_doc(d: Dict) -> "VDom":
        return VDom(int(d["lo"]), int(d["hi"]), int(d["stride"]),
                    frozenset(d["vals"]) if "vals" in d else None)

    def __str__(self) -> str:
        if self.is_top:
            return "⊤"
        if self.vals is not None:
            return "{" + ",".join(str(v) for v in sorted(self.vals)) \
                + "}"
        s = f" step {self.stride}" if self.stride > 1 else ""
        return f"[{self.lo},{self.hi}]{s}"


def _set_stride(vs) -> int:
    xs = sorted(vs)
    if len(xs) < 2:
        return 0
    s = 0
    for a, b in zip(xs, xs[1:]):
        s = _gcd(s, b - a)
    return s


_TOP = VDom(INT32_MIN, INT32_MAX, 1)
_BYTE = VDom(0, 255, 1)


# --------------------------------------------------------------------
# transfer functions (int32-exact, mirroring vm._step)
# --------------------------------------------------------------------

def _nonneg(d: VDom) -> bool:
    return d.lo >= 0


def vdom_alu(sel: int, x: VDom, y: VDom) -> VDom:
    """Abstract transfer of one ALU select.  Exact (elementwise
    through ``_alu_const``) while both sides stay small sets; the
    interval tier is conservative and answers TOP wherever an int32
    wrap cannot be bounded — never a silently-wrong range."""
    if x.vals is not None and y.vals is not None \
            and len(x.vals) * len(y.vals) <= 64:
        return VDom.from_vals(_alu_const(sel, a, b)
                              for a in x.vals for b in y.vals)
    if sel == ALU_ADD:
        lo, hi = x.lo + y.lo, x.hi + y.hi
        if INT32_MIN <= lo and hi <= INT32_MAX:
            return VDom.range(lo, hi, _gcd(x.stride, y.stride) or 1)
        return _TOP
    if sel == ALU_SUB:
        lo, hi = x.lo - y.hi, x.hi - y.lo
        if INT32_MIN <= lo and hi <= INT32_MAX:
            return VDom.range(lo, hi, _gcd(x.stride, y.stride) or 1)
        return _TOP
    if sel == ALU_AND:
        # nonneg & nonneg stays within either operand's magnitude
        if _nonneg(x) and _nonneg(y):
            return VDom.range(0, min(x.hi, y.hi))
        return _TOP
    if sel == ALU_OR:
        if _nonneg(x) and _nonneg(y):
            hi = _or_upper(x.hi, y.hi)
            return VDom.range(max(x.lo, y.lo), hi) \
                if hi <= INT32_MAX else _TOP
        return _TOP
    if sel == ALU_XOR:
        if _nonneg(x) and _nonneg(y):
            hi = _or_upper(x.hi, y.hi)
            return VDom.range(0, hi) if hi <= INT32_MAX else _TOP
        return _TOP
    if sel == ALU_SHL:
        c = y.const_val
        if c is not None and _nonneg(x):
            s = min(max(c, 0), 31)
            lo, hi = x.lo << s, x.hi << s
            if hi <= INT32_MAX:
                return VDom.range(lo, hi, max(x.stride, 1) << s)
        return _TOP
    if sel == ALU_SHR:
        c = y.const_val
        if c is not None and _nonneg(x):
            s = min(max(c, 0), 31)
            return VDom.range(x.lo >> s, x.hi >> s)
        return _TOP
    if sel == ALU_MUL:
        c = y.const_val if y.is_const else \
            (x.const_val if x.is_const else None)
        v = x if y.is_const else y
        if c is not None and c >= 0 and _nonneg(v):
            lo, hi = v.lo * c, v.hi * c
            if hi <= INT32_MAX:
                return VDom.range(lo, hi, max(v.stride, 1) * max(c, 1))
        return _TOP
    return _TOP


def _or_upper(a: int, b: int) -> int:
    """Smallest all-ones bound covering OR/XOR of nonneg x ≤ a,
    y ≤ b: ``(a | b)`` rounded up to 2^k - 1."""
    m = a | b
    return (1 << m.bit_length()) - 1 if m else 0


def _cmp_feasible(sel: int, x: VDom, y: VDom, want: bool) -> bool:
    """May ``x sel y`` evaluate to ``want``?  Exact for small sets,
    bound-based (sound) for intervals."""
    if x.vals is not None and y.vals is not None \
            and len(x.vals) * len(y.vals) <= 4096:
        return any(_fold_cmp(sel, a, b) is want
                   for a in x.vals for b in y.vals)
    from ..models.vm import CMP_EQ, CMP_GE, CMP_LT, CMP_NE
    if sel == CMP_EQ:
        eq_possible = _may_intersect(x, y)
        return eq_possible if want else _may_differ(x, y)
    if sel == CMP_NE:
        return _may_differ(x, y) if want else _may_intersect(x, y)
    if sel == CMP_LT:
        return (x.lo < y.hi) if want else (x.hi >= y.lo)
    if sel == CMP_GE:
        return (x.hi >= y.lo) if want else (x.lo < y.hi)
    return True


def _may_intersect(x: VDom, y: VDom) -> bool:
    if x.hi < y.lo or y.hi < x.lo:
        return False
    c = y.const_val if y.is_const else (
        x.const_val if x.is_const else None)
    if c is not None:
        other = x if y.is_const else y
        return other.contains(c)
    # congruence test on the overlap (sound: sets already handled)
    s = _gcd(x.stride, y.stride)
    if s > 1 and (x.lo - y.lo) % s != 0:
        return False
    return True


def _may_differ(x: VDom, y: VDom) -> bool:
    return not (x.is_const and y.is_const and x.lo == y.lo)


def _refine_cmp(sel: int, d: VDom, k: int, want: bool
                ) -> Optional[VDom]:
    """Restrict ``d`` to values v with ``v sel k == want`` — None for
    bottom.  Exact on sets; interval clamping on eq/lt/ge hulls
    (ne over an interval is left unrefined: sound)."""
    from ..models.vm import CMP_EQ, CMP_GE, CMP_LT, CMP_NE
    if d.vals is not None:
        keep = frozenset(v for v in d.vals
                         if _fold_cmp(sel, v, k) is want)
        return VDom.from_vals(keep) if keep else None
    if sel == CMP_EQ:
        if want:
            return VDom.const(k) if d.contains(k) else None
        return d                        # drop one point: keep hull
    if sel == CMP_NE:
        if not want:
            return VDom.const(k) if d.contains(k) else None
        return d
    lt = (sel == CMP_LT)
    below = want if lt else not want    # keep v < k ?
    if below:
        hi = min(d.hi, k - 1)
        return VDom.range(d.lo, hi, max(d.stride, 1)) \
            if d.lo <= hi else None
    lo = max(d.lo, k)
    return VDom.range(lo, d.hi, max(d.stride, 1)) \
        if lo <= d.hi else None


# --------------------------------------------------------------------
# affine byte provenance
# --------------------------------------------------------------------

#: affine fact: value == scale * byte[idx] + offset, EXACT (no int32
#: wrap for any byte in [0, 255] — checked at construction)
Affine = Tuple[int, int, int]           # (idx, scale, offset)


def _affine_ok(scale: int, offset: int) -> bool:
    for b in (0, 255):
        v = scale * b + offset
        if not (INT32_MIN <= v <= INT32_MAX):
            return False
    return True


def _affine_shift(aff: Optional[Affine], d_scale: int,
                  d_offset: int, mul: bool) -> Optional[Affine]:
    if aff is None:
        return None
    i, s, o = aff
    if mul:
        s, o = s * d_scale, o * d_scale
    else:
        o = o + d_offset
    return (i, s, o) if _affine_ok(s, o) else None


def affine_sat_set(aff: Affine, sel: int, k: int,
                   want: bool) -> FrozenSet[int]:
    """Byte values b for which ``(scale*b + offset) sel k == want``
    — the exact inversion of a guard back to the byte domain."""
    _, s, o = aff
    return frozenset(b for b in range(256)
                     if _fold_cmp(sel, _i32(s * b + o), k) is want)


# --------------------------------------------------------------------
# abstract state
# --------------------------------------------------------------------

class _AbsVal:
    __slots__ = ("dom", "affine")

    def __init__(self, dom: VDom, affine: Optional[Affine] = None):
        self.dom = dom
        self.affine = affine

    def __eq__(self, other):
        return (self.dom == other.dom
                and self.affine == other.affine)

    def __hash__(self):
        return hash((self.dom, self.affine))


_ZERO_AV = _AbsVal(VDom.const(0))
_TOP_AV = _AbsVal(_TOP)


class _AbsState:
    """regs: tuple of 8 _AbsVal; bytes: per-position refined VDom
    (positions absent = full [0,255]); mem: one summary VDom over
    every stored value (plus the initial zeros)."""

    __slots__ = ("regs", "bytes", "mem")

    def __init__(self, regs, bytes_, mem):
        self.regs = regs
        self.bytes = bytes_
        self.mem = mem

    def __eq__(self, other):
        return (self.regs == other.regs and self.bytes == other.bytes
                and self.mem == other.mem)

    def byte_dom(self, i: int) -> VDom:
        return self.bytes.get(i, _BYTE)


def _join_states(a: Optional[_AbsState], b: _AbsState,
                 widen: bool) -> _AbsState:
    if a is None:
        return b
    regs = []
    for x, y in zip(a.regs, b.regs):
        dom = x.dom.widen(y.dom) if widen else x.dom.join(y.dom)
        aff = x.affine if x.affine == y.affine else None
        regs.append(_AbsVal(dom, aff))
    # byte domains only ever live in [0, 255]: plain join terminates
    keys = set(a.bytes) & set(b.bytes)
    bytes_ = {i: a.bytes[i].join(b.bytes[i]) for i in keys}
    bytes_ = {i: d for i, d in bytes_.items() if d != _BYTE}
    mem = a.mem.widen(b.mem) if widen else a.mem.join(b.mem)
    return _AbsState(tuple(regs), bytes_, mem)


# --------------------------------------------------------------------
# published facts
# --------------------------------------------------------------------

@dataclass(frozen=True)
class VsaFact:
    """One OP_BR as the value-set interpreter saw it (join over all
    modeled paths — every concrete execution's operands lie inside
    these domains; ``check_replay`` enforces exactly that)."""
    pc: int
    block: int
    cmp: str
    x_dom: VDom
    y_dom: VDom
    #: exact affine byte provenance of each side, when it survived
    #: every join into this pc
    x_affine: Optional[Affine]
    y_affine: Optional[Affine]
    #: may the comparison come out True / False?  One side False =
    #: the other side is FORCED (the infeasible-edge lint + the
    #: solver's forced-guard seeds)
    feasible_true: bool = True
    feasible_false: bool = False

    def feasible(self, want: bool) -> bool:
        return self.feasible_true if want else self.feasible_false

    def as_doc(self) -> Dict:
        return {
            "pc": int(self.pc), "block": int(self.block),
            "cmp": self.cmp,
            "x_dom": self.x_dom.as_doc(),
            "y_dom": self.y_dom.as_doc(),
            "x_affine": list(self.x_affine) if self.x_affine else None,
            "y_affine": list(self.y_affine) if self.y_affine else None,
            "feasible_true": bool(self.feasible_true),
            "feasible_false": bool(self.feasible_false),
        }

    @staticmethod
    def from_doc(d: Dict) -> "VsaFact":
        return VsaFact(
            pc=int(d["pc"]), block=int(d["block"]), cmp=d["cmp"],
            x_dom=VDom.from_doc(d["x_dom"]),
            y_dom=VDom.from_doc(d["y_dom"]),
            x_affine=tuple(d["x_affine"]) if d.get("x_affine") else None,
            y_affine=tuple(d["y_affine"]) if d.get("y_affine") else None,
            feasible_true=bool(d["feasible_true"]),
            feasible_false=bool(d["feasible_false"]))


@dataclass(frozen=True)
class MemFact:
    """One LDM/STM whose index register's domain the fixpoint
    bounded — the guaranteed-oob-store refinement's evidence."""
    pc: int
    block: int
    op: str                             # "ldm" / "stm"
    idx_dom: VDom

    def as_doc(self) -> Dict:
        return {"pc": int(self.pc), "block": int(self.block),
                "op": self.op, "idx_dom": self.idx_dom.as_doc()}

    @staticmethod
    def from_doc(d: Dict) -> "MemFact":
        return MemFact(pc=int(d["pc"]), block=int(d["block"]),
                       op=d["op"], idx_dom=VDom.from_doc(d["idx_dom"]))


@dataclass
class VsaResult:
    branches: List[VsaFact]
    mem_ops: List[MemFact]
    #: pcs that received abstract state (VSA-reachable); a pc
    #: constprop reaches but VSA does not is a value-range
    #: contradiction (accumulated refinements emptied every path in)
    reached_pcs: Set[int]
    #: per input-byte position: join of the refined domain at every
    #: USE — the priors/grammar surface, NOT a per-edge guarantee
    #: (solver seeding recomputes per-edge forced domains instead)
    byte_domains: Dict[int, VDom] = field(default_factory=dict)
    #: pcs whose in-state was widened (the honesty caveat surface)
    widened_pcs: Set[int] = field(default_factory=set)
    program_sig: str = ""

    @property
    def by_pc(self) -> Dict[int, VsaFact]:
        return {f.pc: f for f in self.branches}

    # -- persistence (corpus-store checkpoint section / sidecar) ------

    def to_doc(self) -> Dict:
        return {
            "schema": VSA_SCHEMA,
            "program_sig": self.program_sig,
            "branches": [f.as_doc() for f in self.branches],
            "mem_ops": [m.as_doc() for m in self.mem_ops],
            "reached_pcs": sorted(int(p) for p in self.reached_pcs),
            "byte_domains": {str(i): d.as_doc()
                             for i, d in sorted(
                                 self.byte_domains.items())},
            "widened_pcs": sorted(int(p) for p in self.widened_pcs),
        }

    @staticmethod
    def from_doc(doc: Dict, program=None) -> Optional["VsaResult"]:
        """Rehydrate a cached document; None when the schema or the
        program signature does not match (a stale cache must re-run
        the fixpoint, never serve another program's domains)."""
        try:
            if doc.get("schema") != VSA_SCHEMA:
                return None
            if program is not None and \
                    doc.get("program_sig") != program_sig(program):
                return None
            return VsaResult(
                branches=[VsaFact.from_doc(d)
                          for d in doc["branches"]],
                mem_ops=[MemFact.from_doc(d)
                         for d in doc.get("mem_ops", [])],
                reached_pcs=set(doc["reached_pcs"]),
                byte_domains={int(i): VDom.from_doc(d)
                              for i, d in
                              doc.get("byte_domains", {}).items()},
                widened_pcs=set(doc.get("widened_pcs", [])),
                program_sig=doc.get("program_sig", ""))
        except (KeyError, TypeError, ValueError):
            return None


def program_sig(program) -> str:
    """Stable identity of the analyzed text: instructions + the
    engine parameters the transfer functions depend on."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(
        np.asarray(program.instrs, dtype=np.int64)).tobytes())
    h.update(json.dumps([int(program.mem_size),
                         int(program.max_steps)]).encode())
    return h.hexdigest()


# --------------------------------------------------------------------
# the fixpoint
# --------------------------------------------------------------------

def analyze_vsa(program) -> VsaResult:
    instrs = np.asarray(program.instrs)
    ni = instrs.shape[0]
    rows = [tuple(int(x) for x in instrs[pc]) for pc in range(ni)]

    block_of_pc: List[int] = []
    cur = -1
    for pc in range(ni):
        if rows[pc][0] == OP_BLOCK:
            cur += 1
        block_of_pc.append(cur)

    state_in: Dict[int, _AbsState] = {}
    joins: Dict[int, int] = {}
    widened: Set[int] = set()
    worklist: List[int] = []
    if ni:
        state_in[0] = _AbsState(tuple(_ZERO_AV for _ in range(N_REGS)),
                                {}, VDom.const(0))
        worklist.append(0)

    #: per-position: join of refined byte domains observed at uses
    use_doms: Dict[int, VDom] = {}

    def flow(pc: int, st: _AbsState) -> None:
        prev = state_in.get(pc)
        n = joins.get(pc, 0)
        widen = n >= WIDEN_AFTER
        joined = _join_states(prev, st, widen)
        if prev is None or joined != prev:
            if widen and prev is not None:
                widened.add(pc)
            state_in[pc] = joined
            joins[pc] = n + 1
            worklist.append(pc)

    def transfer(pc: int, st: _AbsState
                 ) -> List[Tuple[int, _AbsState]]:
        op, a, b, c = rows[pc]
        regs = list(st.regs)
        bytes_, mem = st.bytes, st.mem
        if op == OP_LDB:
            idx = regs[_reg(b)].dom.const_val
            if idx is not None and idx < 0:
                regs[_reg(a)] = _ZERO_AV
            elif idx is not None:
                # in-bounds reads see the byte; short inputs read 0 —
                # the loaded domain must admit both (the replay
                # contract); the affine fact reads "the value LDB
                # produced", which is byte[idx] in-bounds and 0 on
                # short inputs — exactness of the affine inversion is
                # restored per-path by the solver's len >= idx+1
                # constraint
                d = st.byte_dom(idx)
                if not d.contains(0):
                    d = d.join(VDom.const(0))
                regs[_reg(a)] = _AbsVal(d, (idx, 1, 0))
            else:
                regs[_reg(a)] = _AbsVal(_BYTE)
        elif op == OP_LDI:
            regs[_reg(a)] = _AbsVal(VDom.const(b))
        elif op == OP_ALU:
            sel = c & 7
            x = regs[_reg(b)]
            y = regs[(c >> 3) & (N_REGS - 1)]
            dom = vdom_alu(sel, x.dom, y.dom)
            aff = None
            if sel == ALU_ADD and y.dom.is_const:
                aff = _affine_shift(x.affine, 1, y.dom.lo, False)
            elif sel == ALU_ADD and x.dom.is_const:
                aff = _affine_shift(y.affine, 1, x.dom.lo, False)
            elif sel == ALU_SUB and y.dom.is_const:
                aff = _affine_shift(x.affine, 1, -y.dom.lo, False)
            elif sel == ALU_MUL and y.dom.is_const and y.dom.lo >= 0:
                aff = _affine_shift(x.affine, y.dom.lo, 0, True)
            elif sel == ALU_MUL and x.dom.is_const and x.dom.lo >= 0:
                aff = _affine_shift(y.affine, x.dom.lo, 0, True)
            elif sel == ALU_SHL and y.dom.is_const \
                    and 0 <= y.dom.lo <= 31:
                aff = _affine_shift(x.affine, 1 << y.dom.lo, 0, True)
            regs[_reg(a)] = _AbsVal(dom, aff)
        elif op == OP_ADDI:
            x = regs[_reg(b)]
            dom = vdom_alu(ALU_ADD, x.dom, VDom.const(c))
            regs[_reg(a)] = _AbsVal(
                dom, _affine_shift(x.affine, 1, _i32(c), False))
        elif op == OP_LEN:
            # the input length: nonnegative, otherwise unbounded by
            # this analysis (the solver's max_len is a SEARCH cap,
            # not an engine property)
            regs[_reg(a)] = _AbsVal(VDom.range(0, INT32_MAX))
        elif op == OP_LDM:
            regs[_reg(a)] = _AbsVal(mem)
        elif op == OP_STM:
            mem = mem.join(regs[_reg(b)].dom)
        new = _AbsState(tuple(regs), bytes_, mem)

        if op == OP_BR:
            sel = b & 3
            xi, yi = _reg(a), (b >> 2) & (N_REGS - 1)
            x, y = st.regs[xi], st.regs[yi]
            out = []
            for want, succ in ((True, c), (False, pc + 1)):
                if not (0 <= succ < ni):
                    continue
                if not _cmp_feasible(sel, x.dom, y.dom, want):
                    continue
                sregs = list(new.regs)
                sbytes = dict(new.bytes)
                dead = False
                # operand refinement against a constant other side
                for vi, v, o, is_x in ((xi, x, y, True),
                                       (yi, y, x, False)):
                    k = o.dom.const_val
                    if k is None:
                        continue
                    trip = _side_pred(sel, k, want, is_x)
                    if trip is None:
                        continue        # no usable refinement
                    msel, mk, mwant = trip
                    r = _refine_cmp(msel, v.dom, mk, mwant)
                    if r is None:
                        dead = True
                        break
                    sregs[vi] = _AbsVal(r, v.affine)
                    if v.affine is not None:
                        i = v.affine[0]
                        sat = affine_sat_set(v.affine, msel, mk,
                                             mwant)
                        # the guard constrains the LOADED value; on
                        # an in-bounds read that IS byte[i], so the
                        # byte refines to ``current ∩ sat`` — a
                        # short-input path reads 0 instead and the
                        # byte (which then does not exist in the
                        # input) stays vacuously inside any domain
                        cur_b = sbytes.get(i, _BYTE)
                        keep = frozenset(
                            bv for bv in range(256)
                            if cur_b.contains(bv) and bv in sat)
                        if keep:
                            nd = VDom.from_vals(keep)
                            if nd != _BYTE:
                                sbytes[i] = nd
                                use_doms[i] = use_doms.get(
                                    i, nd).join(nd)
                        # empty keep: the guard can only pass via
                        # the short-input zero read; byte stays free
                if dead:
                    continue
                out.append((succ, _AbsState(tuple(sregs), sbytes,
                                            new.mem)))
            return out
        return [(s, new) for s in instr_successors(instrs, pc)
                if 0 <= s < ni]

    iters = 0
    while worklist and iters < _MAX_ITERS:
        iters += 1
        pc = worklist.pop()
        if rows[pc][0] in (OP_HALT, OP_CRASH):
            continue
        for s, out in transfer(pc, state_in[pc]):
            flow(s, out)

    # -- publish branch facts -----------------------------------------
    branches: List[VsaFact] = []
    for pc in sorted(state_in):
        op, a, b, c = rows[pc]
        if op != OP_BR:
            continue
        st = state_in[pc]
        sel = b & 3
        x = st.regs[_reg(a)]
        y = st.regs[(b >> 2) & (N_REGS - 1)]
        branches.append(VsaFact(
            pc=pc, block=block_of_pc[pc], cmp=CMP_NAMES[sel],
            x_dom=x.dom, y_dom=y.dom,
            x_affine=x.affine, y_affine=y.affine,
            feasible_true=_cmp_feasible(sel, x.dom, y.dom, True),
            feasible_false=_cmp_feasible(sel, x.dom, y.dom, False)))

    mem_ops: List[MemFact] = []
    for pc in sorted(state_in):
        op, a, b, c = rows[pc]
        if op not in (OP_LDM, OP_STM):
            continue
        idx = state_in[pc].regs[_reg(b if op == OP_LDM else a)]
        mem_ops.append(MemFact(
            pc=pc, block=block_of_pc[pc],
            op="ldm" if op == OP_LDM else "stm", idx_dom=idx.dom))

    return VsaResult(
        branches=branches, mem_ops=mem_ops,
        reached_pcs=set(state_in),
        byte_domains={i: d for i, d in sorted(use_doms.items())
                      if d != _BYTE},
        widened_pcs=widened, program_sig=program_sig(program))


def _side_pred(sel: int, k: int, want: bool, is_x: bool
               ) -> Optional[Tuple[int, int, bool]]:
    """The branch outcome as a predicate ``v sel' k' == want'`` over
    ONE operand, the other side pinned to constant ``k``.  The x
    side is the predicate itself; the y side mirrors the selector
    (``k < y`` becomes ``y >= k+1``).  None = no usable mirror
    (k+1 would overflow — that side is infeasible anyway)."""
    from ..models.vm import CMP_EQ, CMP_GE, CMP_LT, CMP_NE
    if is_x or sel in (CMP_EQ, CMP_NE):
        return sel, k, want
    if k >= INT32_MAX:
        return None
    below = (sel == CMP_GE) == want     # k>=y is want  ->  y <= k
    # y <= k  <=>  y lt k+1 ; y > k  <=>  y ge k+1
    return (CMP_LT, k + 1, True) if below else (CMP_GE, k + 1, True)


# --------------------------------------------------------------------
# the honesty check: concrete replay conformance
# --------------------------------------------------------------------

def check_replay(program, data: bytes,
                 vsa: Optional[VsaResult] = None) -> List[str]:
    """Execute ``data`` concretely and verify every executed branch
    against the published VSA facts: operands inside the domains,
    taken side marked feasible, affine provenance exact on in-bounds
    reads.  Returns human-readable violations (empty = conformant) —
    the test suite's soundness oracle, and any consumer's spot-check
    before trusting a cached document."""
    from .solver import concrete_run
    vsa = vsa or analyze_vsa(program)
    by_pc = vsa.by_pc
    trace = concrete_run(program, data)
    out: List[str] = []
    for pc, x, y, taken in trace.branches:
        f = by_pc.get(pc)
        if f is None:
            out.append(f"pc {pc}: branch executed but unpublished "
                       f"(VSA missed a reachable pc)")
            continue
        if not f.x_dom.contains(x):
            out.append(f"pc {pc}: x={x} outside {f.x_dom}")
        if not f.y_dom.contains(y):
            out.append(f"pc {pc}: y={y} outside {f.y_dom}")
        if not f.feasible(taken):
            out.append(f"pc {pc}: took the {taken} side marked "
                       f"infeasible")
        for side, v, aff in (("x", x, f.x_affine),
                             ("y", y, f.y_affine)):
            if aff is None:
                continue
            i, s, o = aff
            b = data[i] if 0 <= i < len(data) else 0
            if _i32(s * b + o) != v:
                out.append(f"pc {pc}: {side}={v} breaks affine "
                           f"{s}*byte[{i}]+{o} (byte={b})")
    return out


# --------------------------------------------------------------------
# summary (the kb-lint --json "vsa" section)
# --------------------------------------------------------------------

def vsa_stats(vsa: VsaResult) -> Dict:
    """Mirror of lint.universe_stats for the value-set layer."""
    forced = sum(1 for f in vsa.branches
                 if not (f.feasible_true and f.feasible_false))
    return {
        "n_branch_facts": len(vsa.branches),
        "n_affine": sum(1 for f in vsa.branches
                        if f.x_affine or f.y_affine),
        "n_forced_sides": forced,
        "n_mem_facts": len(vsa.mem_ops),
        "n_byte_positions": len(vsa.byte_domains),
        "byte_domains": {str(i): str(d)
                         for i, d in sorted(vsa.byte_domains.items())},
        "widened_pcs": sorted(vsa.widened_pcs),
        "reached_pcs": len(vsa.reached_pcs),
    }
