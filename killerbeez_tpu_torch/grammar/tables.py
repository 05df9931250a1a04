"""The structure compiler: grammar spec -> fixed-shape device tables.

The port of the JAX package's ``grammar/tables.py`` (numpy).
``compile_grammar`` inline-expands the start rule (nested ``rule``
references up to ``depth_cap``, deeper clipped to free bytes with a
ONE-SHOT warning — never a miscompile) into a flat field program plus
token / alphabet tables, all fixed-shape numpy arrays that
``GrammarTables.device`` ships to a device as one tensor each:

* ``fp_kind / fp_width / fp_aux / fp_grp`` int32[P] — the field
  program.  Kinds: 0 lit, 1 token-alphabet slot, 2 length field,
  3 free bytes.  ``fp_aux`` is the kind-specific link: token id for
  lits, alphabet row for token slots, MEASURED ENTRY INDEX for length
  fields (-1 unresolved), -1 for free bytes.  ``fp_grp`` is the
  rule-instance group — the subtree-regeneration unit;
* ``tok`` uint8[T, TW] + ``tok_len`` int32[T] — interned token bytes;
* ``alpha_tok`` int32[K, AC] + ``alpha_n`` int32[K] — per-field token
  alphabets (rows of token ids; empty alphabets carry n == 0 and the
  kernels guard them);
* ``meta`` int32[4] — ``[nondegen, stage_p, n_entries, clipped]``.
  ``nondegen == 0`` marks the degenerate "anything" grammar: the
  structured mutation then reduces to blind havoc bit-exactly (the
  parity anchor).
  ``stage_p`` (0..256) is the per-lane structured-stage probability
  numerator: a lane is structured when its stage byte < stage_p.

Tables are plain data — compiled once per campaign on the host,
shipped to the device once by the instrumentation or the mutator.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from ..utils.logging import WARNING_MSG
from .spec import Field, Grammar

KIND_LIT = 0
KIND_ALPHA = 1
KIND_LEN = 2
KIND_BLOB = 3

#: default inline-expansion depth cap for nested rule references
DEPTH_CAP = 4
#: default structured-stage probability numerator (of 256): half the
#: lanes in a generation run structured stages, half stay blind
STAGE_P = 128
#: hard entry / alphabet bounds (fixed device table shapes)
MAX_ENTRIES = 96
ALPHA_CAP = 32
MAX_TOK_WIDTH = 8


class GrammarTables(NamedTuple):
    fp_kind: np.ndarray     # int32[P]
    fp_width: np.ndarray    # int32[P]
    fp_aux: np.ndarray      # int32[P]
    fp_grp: np.ndarray      # int32[P]
    tok: np.ndarray         # uint8[T, TW]
    tok_len: np.ndarray     # int32[T]
    alpha_tok: np.ndarray   # int32[K, AC]
    alpha_n: np.ndarray     # int32[K]
    meta: np.ndarray        # int32[4]: nondegen, stage_p, n, clipped

    @property
    def nondegen(self) -> bool:
        return bool(self.meta[0])

    def device(self, dev) -> Tuple:
        """One torch tensor per table on ``dev``, in field order (the
        generation loops and ``grammar_havoc_at`` consume exactly this
        tuple)."""
        import torch
        return tuple(torch.as_tensor(a, device=dev) for a in self)


def compile_grammar(grammar: Grammar, depth_cap: int = DEPTH_CAP,
                    stage_p: int = STAGE_P) -> GrammarTables:
    """Spec -> tables.  Deterministic: expansion order is rule text
    order, tokens interned first-use-first.  Nesting deeper than
    ``depth_cap`` and programs longer than ``MAX_ENTRIES`` clip to
    free bytes — each compile emits AT MOST ONE warning describing
    every clip, and the clipped program still parses every input
    (clipping widens, never narrows, what mutation may touch)."""
    tokens: List[bytes] = []
    tok_index: Dict[bytes, int] = {}
    alphas: List[List[int]] = []
    entries: List[list] = []     # [kind, width, aux, grp, name, of]
    clipped = [0, 0]             # depth clips, entry-cap clips
    grp_next = [0]

    def intern(tb: bytes) -> int:
        tb = bytes(tb[:MAX_TOK_WIDTH]) or b"\x00"
        if tb not in tok_index:
            tok_index[tb] = len(tokens)
            tokens.append(tb)
        return tok_index[tb]

    def emit(kind, width, aux, grp, name="", of=""):
        if len(entries) >= MAX_ENTRIES:
            clipped[1] += 1
            return
        entries.append([kind, int(width), int(aux), int(grp),
                        name, of])

    def expand(rule_name: str, depth: int, grp: int) -> None:
        for f in grammar.rules[rule_name].fields:
            if f.kind == "rule":
                if depth + 1 > depth_cap:
                    clipped[0] += 1
                    emit(KIND_BLOB, 0, -1, grp)
                else:
                    grp_next[0] += 1
                    expand(f.rule, depth + 1, grp_next[0])
            elif f.kind == "lit":
                emit(KIND_LIT, len(f.value), intern(f.value), grp)
            elif f.kind == "token":
                row = [intern(t) for t in f.alphabet[:ALPHA_CAP]]
                alphas.append(row)
                emit(KIND_ALPHA, f.width, len(alphas) - 1, grp)
            elif f.kind == "len":
                emit(KIND_LEN, f.width, -1, grp, of=f.of)
            else:                       # bytes
                emit(KIND_BLOB, f.width, -1, grp, name=f.name)

    if grammar.start:
        expand(grammar.start, 1, 0)
    if not entries:                     # empty grammar = "anything"
        entries.append([KIND_BLOB, 0, -1, 0, "", ""])
    if clipped[0] or clipped[1]:
        WARNING_MSG(
            "grammar: clipped %d nested rule reference(s) beyond "
            "depth cap %d and %d field(s) beyond the %d-entry table "
            "bound to free bytes (structure widens to 'anything' "
            "there; mutation coverage is preserved)",
            clipped[0], depth_cap, clipped[1], MAX_ENTRIES)

    # resolve length fields to the nearest LATER entry with the
    # measured name (forward TLV convention), else the nearest
    # earlier one; unresolved stays -1 (the kernels skip it)
    for i, e in enumerate(entries):
        if e[0] != KIND_LEN:
            continue
        of = e[5]
        cands = [j for j in range(i + 1, len(entries))
                 if entries[j][4] == of] or \
                [j for j in range(i) if entries[j][4] == of]
        if of and cands:
            e[2] = cands[0]

    n = len(entries)
    nondegen = 0 if (n == 1 and entries[0][0] == KIND_BLOB
                     and entries[0][1] == 0) else 1

    fp = np.asarray([[e[0], e[1], e[2], e[3]] for e in entries],
                    dtype=np.int32)
    T = max(len(tokens), 1)
    TW = max((len(t) for t in tokens), default=1)
    TW = max(TW, 1)
    tok = np.zeros((T, TW), dtype=np.uint8)
    tok_len = np.zeros((T,), dtype=np.int32)
    for i, t in enumerate(tokens):
        tok[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        tok_len[i] = len(t)
    K = max(len(alphas), 1)
    AC = max(max((len(a) for a in alphas), default=1), 1)
    alpha_tok = np.zeros((K, AC), dtype=np.int32)
    alpha_n = np.zeros((K,), dtype=np.int32)
    for i, row in enumerate(alphas):
        alpha_tok[i, :len(row)] = row
        alpha_n[i] = len(row)
    meta = np.asarray(
        [nondegen, int(stage_p), n, clipped[0] + clipped[1]],
        dtype=np.int32)
    return GrammarTables(
        fp_kind=fp[:, 0].copy(), fp_width=fp[:, 1].copy(),
        fp_aux=fp[:, 2].copy(), fp_grp=fp[:, 3].copy(),
        tok=tok, tok_len=tok_len,
        alpha_tok=alpha_tok, alpha_n=alpha_n, meta=meta)


def degenerate_tables(stage_p: int = STAGE_P) -> GrammarTables:
    """Compiled tables of the degenerate grammar (``nondegen == 0``)
    — what campaigns without --grammar implicitly run."""
    from .spec import degenerate_grammar
    return compile_grammar(degenerate_grammar(), stage_p=stage_p)
