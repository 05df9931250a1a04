"""Grammar auto-derivation from the static layer (analysis/).

``derive_grammar`` reads the same branch facts that feed
``extract_dictionary`` and folds them into a field layout:

* single-byte positional eq/ne compares (``expect_byte`` chains)
  pin positions — one value becomes a literal, several become a
  token field whose alphabet is the value set;
* multi-byte eq/ne compares over a CONSECUTIVE dep span (the wide
  little-endian constants the dictionary now also emits) become
  token fields at the compare width;
* a position guarded by lt/ge (a range check — the KBVM idiom for
  "read a length byte, bound a loop with it") becomes a length
  field measuring the free-bytes field that follows it;
* everything unclaimed is free bytes, the tail unbounded.

The derivation is deliberately conservative: where analysis says
nothing the grammar says "anything", so a derived grammar can only
CONSTRAIN mutation where structure is proven, never exclude bytes an
uncovered branch might read (the same doctrine as the focus masks).
A program with no usable facts derives the degenerate grammar — and
degenerate compiles to the blind-parity tables, so auto-derivation
is always safe to turn on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..analysis.dataflow import ANY, DataflowResult, analyze_dataflow
from .spec import Field, Grammar, Rule, blob, length, lit, token

#: alphabet size cap per derived token field (matches tables.ALPHA_CAP
#: conservatively; larger value sets stay free bytes — a position
#: compared against dozens of values is a dispatch byte, not magic)
MAX_ALPHA = 16


def _vsa_facts(vsa) -> Tuple[Dict[int, Set[int]], Set[int]]:
    """Per-position value sets and bound positions from VSA affine
    guard inversion — the facts the guarding-constant pass provably
    cannot see: a byte compared through arithmetic (``b0+200==300``
    folds to an affine operand vs a constant outside 0..255) inverts
    to the byte values that flip the guard.  eq/ne guards contribute
    alphabets; lt/ge guards over an affine byte mark the position as
    a length-style bound (the KBVM range-check idiom), exactly like
    the literal ``bounds`` path.  Length-dependent guards exclude
    themselves: LEN yields a non-constant domain, so no constant
    other side exists to invert against."""
    from ..analysis.vsa import affine_sat_set
    from ..models.vm import CMP_EQ
    pins: Dict[int, Set[int]] = {}
    bounds: Set[int] = set()
    for f in sorted(vsa.branches, key=lambda f: f.pc):
        for aff, other in ((f.x_affine, f.y_dom),
                           (f.y_affine, f.x_dom)):
            if aff is None or other.const_val is None:
                continue
            i = aff[0]
            if f.cmp in ("eq", "ne"):
                # the values solving the equality are the magic
                # values regardless of which side carries the byte
                sat = affine_sat_set(aff, CMP_EQ,
                                     other.const_val, True)
                if 0 < len(sat) <= MAX_ALPHA:
                    pins.setdefault(i, set()).update(sat)
            else:                       # lt / ge: a range check
                bounds.add(i)
    return pins, bounds


def derive_grammar(program,
                   result: Optional[DataflowResult] = None,
                   vsa=None) -> Grammar:
    """Fold branch facts into a field layout.  With ``vsa`` (a
    ``VsaResult``), affine guard inversion adds per-field alphabets
    and bound positions the literal pass cannot derive; with
    ``vsa=None`` (the default) the output is bit-identical to the
    pre-VSA derivation — the parity anchor."""
    result = result or analyze_dataflow(program)

    pins: Dict[int, Set[int]] = {}
    wide: Dict[Tuple[int, int], Set[int]] = {}
    bounds: Set[int] = set()
    if vsa is not None:
        vpins, vbounds = _vsa_facts(vsa)
        for i, vals in vpins.items():
            pins.setdefault(i, set()).update(vals)
        bounds |= vbounds
    for f in sorted(result.branches, key=lambda f: f.pc):
        if f.const is None or f.deps is ANY or not f.deps:
            continue
        ds = sorted(f.deps)
        if len(ds) == 1:
            i = ds[0]
            if f.cmp in ("eq", "ne") and 0 <= f.const <= 255:
                pins.setdefault(i, set()).add(f.const)
            elif f.cmp in ("lt", "ge") and not f.len_dep:
                bounds.add(i)
        elif (f.cmp in ("eq", "ne") and 2 <= len(ds) <= 4
                and ds == list(range(ds[0], ds[0] + len(ds)))):
            u = f.const & 0xFFFFFFFF
            if u < (1 << (8 * len(ds))):
                wide.setdefault((ds[0], len(ds)), set()).add(u)

    # claim bytes: single-byte pins first (expect chains are the
    # strongest facts), then non-overlapping wide spans, then length
    # bytes — deterministic position order throughout
    claimed: Set[int] = set(pins)
    items: List[Tuple[int, int, str, List[int]]] = [
        (i, 1, "pin", sorted(v)) for i, v in sorted(pins.items())]
    for (s, w) in sorted(wide):
        span = range(s, s + w)
        if any(p in claimed for p in span):
            continue
        claimed.update(span)
        items.append((s, w, "wide", sorted(wide[(s, w)])))
    for b in sorted(bounds):
        if b not in claimed:
            claimed.add(b)
            items.append((b, 1, "len", []))
    items.sort()

    fields: List[Field] = []
    pending_len: Optional[str] = None
    cur = 0

    def gap(to: int) -> None:
        nonlocal pending_len
        if to > cur:
            fields.append(blob(to - cur, name=pending_len or ""))
            pending_len = None

    for s, w, kind, vals in items:
        if s < cur:
            continue                    # overlap loser — skip
        gap(s)
        if kind == "pin":
            if len(vals) == 1:
                fields.append(lit(bytes([vals[0]])))
            elif len(vals) <= MAX_ALPHA:
                fields.append(token([bytes([v]) for v in vals], 1))
            else:
                fields.append(blob(1))
        elif kind == "wide":
            toks = [v.to_bytes(w, "little")
                    for v in vals[:MAX_ALPHA]]
            fields.append(token(toks, w))
        else:                           # len
            name = f"m{s}"
            fields.append(length(of=name, width=1))
            pending_len = name
        cur = s + w
    # unbounded tail — measured by a trailing length field if one is
    # still waiting for its region
    fields.append(blob(0, name=pending_len or ""))

    return Grammar(rules={"msg": Rule(name="msg",
                                      fields=tuple(fields))},
                   start="msg")
