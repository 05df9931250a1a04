"""The generated target zoo: parameterized KBVM program families
with PLANTED, CERTIFIED deep bugs (the port of the JAX package's
``models/zoo.py``; the programs are the same bytes).

Each family is a program GENERATOR over a small parameter space —
the knobs that make a bug blind-havoc-hostile by construction:

  * ``tlv``    — nested TLV headers (``depth`` levels): each level
                 pins a type byte and checks its length byte against
                 the measured remainder;
  * ``chain``  — a width-``width`` run of consecutive length fields,
                 each one byte, each required to equal the measured
                 input length minus its own offset (the mutual
                 consistency blind insert/delete always breaks);
  * ``cksum``  — a 32-bit little-endian magic (one wide compare — the
                 dictionary/derivation wide-constant shape) plus a
                 running sum/xor checksum over the payload
                 (``style``) that must match a header byte.

Behind the structure sits a COMMAND TOKEN field: a small operation
alphabet (the protocol's command set), with the planted bug behind
the one rare command the benign seed never uses.  ``bug`` widens the
token (2 + bug bytes), deepening the jackpot blind havoc would need.

The deep gate deliberately leaks NO incremental coverage: every
structural constraint and the trigger-command compare fold into one
verdict register and ONE branch into the crash block (an unchecked
wild store, so the deep edge and the crash coincide).  Blind
coverage-guided havoc cannot climb it byte-by-byte — it must hold
the whole header AND jackpot the trigger token in one candidate.  A
grammar-structured lane, by contrast, protects literals and lengths
by construction and reaches the trigger by ONE token substitution
from the field's alphabet.  That separation is what ``bench.py
--grammar`` A/B-gates.

Zoo targets resolve through the ordinary target registry under
``zoo:`` names — ``zoo:tlv:depth=2,bug=1`` — so every tool
(kb-lint, kb-solve, bench, --target options) takes them unchanged.
``build_zoo`` returns the full bundle: program, benign seed, crash
witness, deep edge, and the family's hand-written grammar.

Certification (``certify_zoo``, surfaced as ``kb-zoo certify`` and
the CI zoo lane): the program lints clean of errors, the benign seed
does NOT reach the deep edge, the constructed witness DOES crash
through it (exact concrete semantics), and the exact solver's
verdict on the deep edge is recorded (``sat`` where the constraint
walk is in reach; the checksum loop lands ``unknown`` by design —
the witness is then the certificate, same doctrine as magicsum_vm).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

from ..grammar.spec import Grammar, Rule, blob, length, lit, token
from .compiler import Assembler
from .vm import Program

#: registry-name prefix for generated targets
ZOO_PREFIX = "zoo:"

#: the bench/CI-gated family instances: deep enough that blind havoc
#: at bench budgets provably whiffs, shallow enough that a structured
#: campaign cracks them in seconds on CPU
GATED_NAMES = (
    "zoo:tlv:depth=2,bug=1",
    "zoo:chain:width=3,bug=1",
    "zoo:cksum:style=sum,bug=1",
)

_DEFAULTS = {
    "tlv": {"depth": 2, "bug": 1},
    "chain": {"width": 3, "bug": 1},
    "cksum": {"style": "sum", "bug": 1},
}
_BOUNDS = {"depth": (1, 4), "width": (1, 6), "bug": (0, 4)}

def _tokens(bug: int) -> Tuple[Tuple[bytes, ...], bytes]:
    """The command alphabet at planted-bug depth ``bug``: four benign
    operation tokens plus the trigger, all ``2 + bug`` bytes wide."""
    w = 2 + bug
    benign = tuple(bytes([k, k << 4]).ljust(w, b"\x00")
                   for k in range(1, 5))
    trigger = (b"\xEE\x66" + b"\xEE" * bug)[:w]
    return benign + (trigger,), trigger


class ZooTarget(NamedTuple):
    name: str                       # canonical "zoo:..." name
    family: str
    params: Dict
    program: Program
    seed: bytes                     # benign: every guard but the bug
    crash: bytes                    # witness: crashes through the bug
    deep_edge: Tuple[int, int]      # (from_block, to_block)
    grammar: Grammar                # the family's structure spec


def parse_zoo_name(name: str) -> Tuple[str, Dict]:
    """``zoo:family[:k=v,...]`` -> (family, full param dict)."""
    if not name.startswith(ZOO_PREFIX):
        raise ValueError(f"not a zoo target name: {name!r}")
    rest = name[len(ZOO_PREFIX):]
    family, _, raw = rest.partition(":")
    if family not in _DEFAULTS:
        raise ValueError(
            f"unknown zoo family {family!r}; known: "
            f"{', '.join(sorted(_DEFAULTS))}")
    params = dict(_DEFAULTS[family])
    for item in filter(None, raw.split(",")):
        k, eq, v = item.partition("=")
        if not eq or k not in params:
            raise ValueError(
                f"bad zoo parameter {item!r} for family {family!r} "
                f"(knobs: {', '.join(sorted(params))})")
        params[k] = v if k == "style" else int(v)
    for k, v in params.items():
        if k == "style":
            if v not in ("sum", "xor"):
                raise ValueError("cksum style must be sum or xor")
        else:
            lo, hi = _BOUNDS[k]
            if not (lo <= v <= hi):
                raise ValueError(
                    f"zoo {k}={v} out of range [{lo}, {hi}]")
    return family, params


def zoo_name(family: str, params: Dict) -> str:
    """Canonical name (sorted knobs) for a (family, params) pair."""
    items = ",".join(f"{k}={params[k]}" for k in sorted(params))
    return f"{ZOO_PREFIX}{family}:{items}"


class _Gen:
    """Assembler wrapper that counts blocks, so generators can report
    the deep edge as (guard_block, win_block) indices directly."""

    def __init__(self, name: str, mem_size: int, max_steps: int):
        self.a = Assembler(name, mem_size=mem_size,
                           max_steps=max_steps)
        self.nb = 0

    def block(self) -> int:
        self.a.block()
        self.nb += 1
        return self.nb - 1

    def expect(self, index: int, value: int, fail: str) -> int:
        """expect_byte + its match-path block; returns that block."""
        self.a.expect_byte(1, 2, index, value, fail)
        self.nb += 1
        return self.nb - 1

    def win(self) -> None:
        """The planted bug: an unchecked wild store, then halt."""
        self.a.ldi(6, -1)
        self.a.ldi(7, 1)
        self.a.stm(6, 7)
        self.a.halt(0)

    # -- fused-verdict folds (r6 accumulates, 0 = all constraints
    # -- hold; ONE branch consumes it — no incremental coverage leak)

    def acc_init(self) -> None:
        self.a.ldi(6, 0)

    def fold_byte(self, index: int, value: int) -> None:
        """r6 |= input[index] ^ value."""
        a = self.a
        a.ldi(1, index)
        a.ldb(2, 1)
        a.ldi(3, value)
        a.alu("xor", 4, 2, 3)
        a.alu("or", 6, 6, 4)

    def fold_len(self, index: int, offset: int) -> None:
        """r6 |= input[index] ^ (len - offset) (r5 holds len)."""
        a = self.a
        a.ldi(1, index)
        a.ldb(2, 1)
        a.ldi(3, offset)
        a.alu("sub", 4, 5, 3)
        a.alu("xor", 4, 2, 4)
        a.alu("or", 6, 6, 4)

    def verdict(self, fail: str) -> Tuple[int, int]:
        """The single deep branch: r6 != 0 -> fail, else fall into
        the win block (wild store).  Returns (guard, win) blocks."""
        guard = self.nb - 1
        self.a.ldi(3, 0)
        self.a.br("ne", 6, 3, fail)
        win = self.block()
        self.win()
        return guard, win


def _gen_tlv(depth: int, bug: int):
    g = _Gen(f"zoo_tlv_d{depth}", mem_size=16, max_steps=1024)
    a = g.a
    tokens, trigger = _tokens(bug)
    W = len(trigger)
    header = 2 + 2 * depth
    total = header + W + 2
    g.block()                               # entry
    a.load_len(5)
    a.ldi(3, total)
    a.br("lt", 5, 3, "exit")
    g.block()
    # the magic is ordinary shallow coverage (blind climbs it fine)
    g.expect(0, ord("Z"), "exit")
    g.expect(1, ord("1"), "exit")
    g.acc_init()
    for i in range(1, depth + 1):
        g.fold_byte(2 * i, 0x10 + (i - 1))
        # level i's length byte == measured remainder after its header
        g.fold_len(2 * i + 1, 2 + 2 * i)
    for j, tb in enumerate(trigger):
        g.fold_byte(header + j, tb)
    guard, win = g.verdict("exit")
    a.label("exit")
    g.block()
    a.halt(0)
    prog = a.build(block_seed=0x200 + depth * 16 + bug)

    def body(tok: bytes) -> bytes:
        pay = tok + b"\x00\x00"
        out = bytearray(b"Z1")
        for i in range(1, depth + 1):
            out += bytes([0x10 + (i - 1),
                          2 * (depth - i) + len(pay)])
        return bytes(out) + pay

    return prog, body(tokens[0]), body(trigger), (guard, win)


def _gen_chain(width: int, bug: int):
    g = _Gen(f"zoo_chain_w{width}", mem_size=16, max_steps=1024)
    a = g.a
    tokens, trigger = _tokens(bug)
    W = len(trigger)
    header = 1 + width
    total = header + W + 2
    g.block()                               # entry
    a.load_len(5)
    a.ldi(3, total)
    a.br("lt", 5, 3, "exit")
    g.block()
    g.expect(0, 0xC5, "exit")
    g.acc_init()
    for i in range(1, width + 1):
        # field i (at position i) == len - (i + 1): consecutive
        # fields differ by exactly 1 and the last measures the tail
        g.fold_len(i, i + 1)
    for j, tb in enumerate(trigger):
        g.fold_byte(header + j, tb)
    guard, win = g.verdict("exit")
    a.label("exit")
    g.block()
    a.halt(0)
    prog = a.build(block_seed=0x300 + width * 16 + bug)

    def body(tok: bytes) -> bytes:
        pay = tok + b"\x00\x00"
        total_b = header + len(pay)
        fields = bytes(total_b - (i + 1) for i in range(1, width + 1))
        return bytes([0xC5]) + fields + pay

    return prog, body(tokens[0]), body(trigger), (guard, win)


_CKSUM_MAGIC = 0x4D534B43               # "CKSM" little-endian


def _cksum(style: str, payload: bytes) -> int:
    if style == "sum":
        return sum(payload) & 0xFF
    ck = 0
    for x in payload:
        ck ^= x
    return ck


def _gen_cksum(style: str, bug: int):
    g = _Gen(f"zoo_cksum_{style}", mem_size=16, max_steps=2048)
    a = g.a
    tokens, trigger = _tokens(bug)
    W = len(trigger)
    pay0 = 5 + W                            # payload start (summed)
    total = pay0 + 2
    g.block()                               # entry
    a.load_len(5)
    a.ldi(3, total)
    a.br("lt", 5, 3, "exit")
    g.block()                               # assemble 32-bit LE magic
    a.ldi(6, 256)
    a.ldi(1, 3)
    a.ldb(3, 1)
    for i in (2, 1, 0):
        a.alu("mul", 3, 3, 6)
        a.ldi(1, i)
        a.ldb(2, 1)
        a.alu("add", 3, 3, 2)               # r3 = LE word b0..b3
    a.ldi(4, _CKSUM_MAGIC >> 16)            # LDI is 2^24-bounded:
    a.ldi(7, 16)                            # build the word hi/lo
    a.alu("shl", 4, 4, 7)
    a.ldi(7, _CKSUM_MAGIC & 0xFFFF)
    a.alu("or", 4, 4, 7)
    a.br("ne", 3, 4, "exit")                # ONE wide compare
    g.block()
    a.ldi(7, 0)                             # checksum acc
    a.ldi(1, pay0)                          # i = payload start: the
    #                                         command token is NOT
    #                                         summed, so a token
    #                                         substitution keeps the
    #                                         seed's checksum valid
    g.block()                               # loop head
    a.label("ck_loop")
    a.br("ge", 1, 5, "ck_cmp")
    g.block()                               # body
    a.ldb(2, 1)
    a.alu("add" if style == "sum" else "xor", 7, 7, 2)
    a.addi(1, 1, 1)
    a.jmp("ck_loop")
    a.label("ck_cmp")
    g.block()
    g.acc_init()                            # r6 = verdict
    a.ldi(3, 255)
    a.alu("and", 7, 7, 3)                   # acc & 0xFF
    a.ldi(1, 4)
    a.ldb(2, 1)                             # stored checksum byte
    a.alu("xor", 4, 2, 7)
    a.alu("or", 6, 6, 4)
    for j, tb in enumerate(trigger):
        g.fold_byte(5 + j, tb)
    guard, win = g.verdict("exit")
    a.label("exit")
    g.block()
    a.halt(0)
    prog = a.build(block_seed=0x400 + (style == "xor") * 16 + bug)

    def body(tok: bytes) -> bytes:
        pay = b"\x01\x02"
        return b"CKSM" + bytes([_cksum(style, pay)]) + tok + pay

    return prog, body(tokens[0]), body(trigger), (guard, win)


def _cmd_field(bug: int):
    """The command-token field: the full operation alphabet, trigger
    included — a structured lane reaches the planted bug by ONE token
    substitution here."""
    alpha, _ = _tokens(bug)
    return token(list(alpha), width=2 + bug)


def _grammar_tlv(depth: int, bug: int) -> Grammar:
    fields = [lit(b"Z1")]
    for i in range(depth):
        fields.append(lit(bytes([0x10 + i])))
        # every level's length byte tracks total-length deltas; the
        # innermost parse-measures the tail exactly
        fields.append(length(of="tail", width=1))
    fields.append(_cmd_field(bug))
    fields.append(blob(0, name="tail"))
    return Grammar(rules={"msg": Rule("msg", tuple(fields))},
                   start="msg")


def _grammar_chain(width: int, bug: int) -> Grammar:
    fields = [lit(b"\xC5")]
    fields += [length(of="tail", width=1) for _ in range(width)]
    fields.append(_cmd_field(bug))
    fields.append(blob(0, name="tail"))
    return Grammar(rules={"msg": Rule("msg", tuple(fields))},
                   start="msg")


def _grammar_cksum(style: str, bug: int) -> Grammar:
    fields = (lit(b"CKSM"), blob(1, name="ck"), _cmd_field(bug),
              blob(0, name="tail"))
    return Grammar(rules={"msg": Rule("msg", fields)}, start="msg")


_FAMILIES = {
    "tlv": (lambda p: _gen_tlv(p["depth"], p["bug"]),
            lambda p: _grammar_tlv(p["depth"], p["bug"])),
    "chain": (lambda p: _gen_chain(p["width"], p["bug"]),
              lambda p: _grammar_chain(p["width"], p["bug"])),
    "cksum": (lambda p: _gen_cksum(p["style"], p["bug"]),
              lambda p: _grammar_cksum(p["style"], p["bug"])),
}


def zoo_families() -> Dict[str, Dict]:
    """family -> default parameter dict (the generator knobs)."""
    return {k: dict(v) for k, v in _DEFAULTS.items()}


def build_zoo(name: str) -> ZooTarget:
    """Generate the full bundle for one ``zoo:...`` name
    (deterministic: same name, same program bytes)."""
    family, params = parse_zoo_name(name)
    gen, gram = _FAMILIES[family]
    program, seed, crash, deep_edge = gen(params)
    return ZooTarget(name=zoo_name(family, params), family=family,
                     params=params, program=program, seed=seed,
                     crash=crash, deep_edge=deep_edge,
                     grammar=gram(params))


def zoo_program(name: str) -> Program:
    """The target-registry hook: just the Program."""
    return build_zoo(name).program


def certify_zoo(name: str, solve_budget: int = 20000) -> Dict:
    """Certify one zoo instance's planted bug at generation time.

    Hard requirements (``certified``): lints clean of errors, the
    benign seed misses the deep edge AND exits clean, the witness
    crashes THROUGH the deep edge under exact concrete semantics.
    The solver verdict is recorded alongside (``sat`` = the edge is
    also constraint-walk reachable; ``unknown`` on the checksum
    family's loop is expected and fine — the witness certifies)."""
    from .. import FUZZ_CRASH, FUZZ_NONE
    from ..analysis.lint import SEV_ERROR, lint_program
    from ..analysis.solver import concrete_run, solve_edge

    t = build_zoo(name)
    findings = lint_program(t.program)
    errors = [f.as_dict() for f in findings
              if f.severity == SEV_ERROR]
    seed_tr = concrete_run(t.program, t.seed)
    crash_tr = concrete_run(t.program, t.crash)
    seed_ok = (t.deep_edge not in seed_tr.edges
               and seed_tr.status == FUZZ_NONE)
    crash_ok = (t.deep_edge in crash_tr.edges
                and crash_tr.status == FUZZ_CRASH)
    sv = solve_edge(t.program, t.deep_edge, budget=solve_budget)
    return {
        "name": t.name,
        "deep_edge": [int(t.deep_edge[0]), int(t.deep_edge[1])],
        "lint_errors": errors,
        "seed_benign": bool(seed_ok),
        "witness_crashes": bool(crash_ok),
        "solver": sv.status,
        "certified": bool(not errors and seed_ok and crash_ok),
    }
