"""Grammar spec model: rules of fields, JSON codec, the degenerate
"anything" grammar.

A grammar is a set of named rules; each rule is a FLAT sequence of
fields.  Field kinds:

* ``lit``    — fixed bytes (magic headers, opcode bytes);
* ``token``  — one slot whose value is drawn from a per-field token
  alphabet (the dictionary-seeded alternatives: versions, commands,
  wide little-endian constants);
* ``len``    — a little-endian length field measuring a NAMED later
  field in the same rule expansion (TLV length bytes; the repair
  kernel keeps it consistent after insert/delete);
* ``bytes``  — free bytes: fixed width, or width 0 = "the rest" /
  "whatever the measuring len field says";
* ``rule``   — a nested rule reference, inline-expanded by the
  compiler up to its depth cap.

The JSON form mirrors the model one field-object per entry, bytes
hex-encoded::

    {"start": "msg", "rules": {"msg": [
        {"lit": "53544b31"},
        {"token": ["01", "02", "ff"], "width": 1},
        {"len": "payload", "width": 1},
        {"bytes": 0, "name": "payload"},
        {"rule": "msg"}]}}

The **degenerate grammar** is one rule with one ``bytes 0`` field:
"anything".  It compiles to tables whose ``nondegen`` flag is 0, and
under it every structured kernel is bit-identical to blind havoc —
the parity anchor the generation loops pin (tests/test_torch_grammar.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class Field:
    kind: str                       # lit / token / len / bytes / rule
    value: bytes = b""              # lit
    alphabet: tuple = ()            # token: tuple of bytes values
    width: int = 0                  # token/len slot width; bytes width
    of: str = ""                    # len: name of the measured field
    name: str = ""                  # referenced by len fields
    rule: str = ""                  # rule reference

    def __post_init__(self):
        if self.kind not in ("lit", "token", "len", "bytes", "rule"):
            raise ValueError(f"unknown field kind {self.kind!r}")
        if self.kind == "lit" and not self.value:
            raise ValueError("lit field needs non-empty bytes")
        if self.kind == "len" and self.width not in (1, 2, 4):
            raise ValueError("len field width must be 1, 2 or 4")
        if self.kind == "rule" and not self.rule:
            raise ValueError("rule field needs a rule name")


def lit(value: bytes) -> Field:
    return Field(kind="lit", value=bytes(value))


def token(alphabet, width: int = 0) -> Field:
    alpha = tuple(bytes(t) for t in alphabet)
    if width <= 0:
        width = max((len(t) for t in alpha), default=1)
    return Field(kind="token", alphabet=alpha, width=width)


def length(of: str, width: int = 1) -> Field:
    return Field(kind="len", of=of, width=width)


def blob(width: int = 0, name: str = "") -> Field:
    return Field(kind="bytes", width=int(width), name=name)


def ref(rule: str) -> Field:
    return Field(kind="rule", rule=rule)


@dataclass(frozen=True)
class Rule:
    name: str
    fields: tuple = ()              # tuple of Field (may be empty)


@dataclass
class Grammar:
    rules: Dict[str, Rule] = dc_field(default_factory=dict)
    start: str = ""

    def __post_init__(self):
        if self.start and self.start not in self.rules:
            raise ValueError(f"start rule {self.start!r} undefined")
        for r in self.rules.values():
            for f in r.fields:
                if f.kind == "rule" and f.rule not in self.rules:
                    raise ValueError(
                        f"rule {r.name!r} references undefined rule "
                        f"{f.rule!r}")

    # -- JSON codec ---------------------------------------------------

    def to_json(self) -> str:
        def enc(f: Field) -> dict:
            if f.kind == "lit":
                return {"lit": f.value.hex()}
            if f.kind == "token":
                d = {"token": [t.hex() for t in f.alphabet]}
                if f.width:
                    d["width"] = f.width
                return d
            if f.kind == "len":
                return {"len": f.of, "width": f.width}
            if f.kind == "bytes":
                d = {"bytes": f.width}
                if f.name:
                    d["name"] = f.name
                return d
            return {"rule": f.rule}
        return json.dumps({
            "start": self.start,
            "rules": {n: [enc(f) for f in r.fields]
                      for n, r in sorted(self.rules.items())}})

    @classmethod
    def from_json(cls, text: str) -> "Grammar":
        d = json.loads(text)
        if not isinstance(d, dict) or "rules" not in d:
            raise ValueError('grammar JSON needs {"rules": {...}}')
        rules: Dict[str, Rule] = {}
        for name, fl in d["rules"].items():
            fields: List[Field] = []
            for fd in fl:
                if "lit" in fd:
                    fields.append(lit(bytes.fromhex(fd["lit"])))
                elif "token" in fd:
                    fields.append(token(
                        [bytes.fromhex(t) for t in fd["token"]],
                        int(fd.get("width", 0))))
                elif "len" in fd:
                    fields.append(length(fd["len"],
                                         int(fd.get("width", 1))))
                elif "bytes" in fd:
                    fields.append(blob(int(fd["bytes"]),
                                       fd.get("name", "")))
                elif "rule" in fd:
                    fields.append(ref(fd["rule"]))
                else:
                    raise ValueError(f"unknown field object {fd!r}")
            rules[name] = Rule(name=name, fields=tuple(fields))
        start = d.get("start") or (sorted(rules) and sorted(rules)[0])
        return cls(rules=rules, start=start)


def degenerate_grammar() -> Grammar:
    """The one-rule "anything" grammar: a single unbounded free-bytes
    field.  Compiles with ``nondegen == 0`` — the parity anchor."""
    return Grammar(rules={"any": Rule(name="any",
                                      fields=(blob(0),))},
                   start="any")


def load_grammar(source: str) -> Grammar:
    """Grammar from a JSON string, a ``@file`` path, or the literal
    name ``degenerate`` — the option-string entry point the
    instrumentation / mutator option schemas share."""
    src = source.strip()
    if src == "degenerate":
        return degenerate_grammar()
    if src.startswith("@"):
        with open(src[1:], "r", encoding="utf-8") as fh:
            src = fh.read()
    return Grammar.from_json(src)
