"""Grammar-structured mutator: the host-driven twin of the structured
generation tier.

The port of the JAX package's ``mutators/grammar.py``.
``GrammarMutator`` compiles a grammar spec (inline JSON, ``@file``,
``degenerate``, or ``auto`` derived from a named target's static
analysis) once at construction, ships its tables to the mutator's
device once, and draws every lane with ``grammar_havoc_at`` — the same
structured mutation the generation loops run, so host-batch campaigns
and -G campaigns draw identical structured candidates for identical
(seed, key) pairs.  The candidates then run through the VM like any
unfused mutator's (``kbz_vm_kernel`` on the card).

Parity anchor: with the degenerate grammar every candidate is
bit-identical to ``HavocMutator`` at the same seed and stack_pow2.
``fused_spec`` is the plain havoc spec, as in the JAX package: under
-G the harness's own ``grammar`` option supplies the tables, and an
explicit ``cuda_fused`` engine fuses it as plain havoc (with a
warning); the default ``cuda`` engine never fuses it
(``jit_harness.wants_fused``).
"""

from __future__ import annotations

from ..grammar import compile_grammar, derive_grammar, grammar_havoc_at
from ..grammar.spec import load_grammar
from ..grammar.tables import STAGE_P
from .randomized import _KeyedMutator


class GrammarMutator(_KeyedMutator):
    """Structure-aware havoc: field-aware splice, token substitution,
    length repair, and subtree regeneration interleaved with blind
    stacked edits, per-lane stage-byte selected."""
    name = "grammar"
    OPTION_SCHEMA = {"stack_pow2": int, "grammar": str,
                     "grammar_stage": int, "target": str}
    OPTION_DESCS = {
        "stack_pow2": "max stacked edits = 2**stack_pow2 (default 4)",
        "grammar": "spec source: inline JSON, @file, 'degenerate', "
                   "or 'auto' (derive from the static analysis of "
                   "--target)",
        "grammar_stage": "structured-stage probability numerator of "
                         "256 (default 128: half the lanes)",
        "target": "built-in target name for grammar='auto' "
                  "derivation",
    }
    DEFAULTS = {"stack_pow2": 4, "grammar": "degenerate",
                "grammar_stage": STAGE_P, "target": ""}

    def __init__(self, options, input_bytes, device="cuda"):
        super().__init__(options, input_bytes, device=device)
        sp = int(self.options["stack_pow2"])
        if not (1 <= sp <= 7):
            raise ValueError("stack_pow2 must be in 1..7")
        src = str(self.options["grammar"]) or "degenerate"
        if src == "auto":
            tgt = str(self.options["target"])
            if not tgt:
                raise ValueError(
                    "grammar='auto' derivation needs a target name "
                    "(the grammar comes from its static analysis)")
            from ..models.targets import get_target
            gspec = derive_grammar(get_target(tgt))
        else:
            gspec = load_grammar(src)
        self.grammar_tables = compile_grammar(
            gspec, stage_p=int(self.options["grammar_stage"]))
        self._gt = self.grammar_tables.device(self.device)

    def _generate(self, its):
        return grammar_havoc_at(self._seed_on_device(), self.seed_len,
                                self._keys(its), self.grammar_tables,
                                self._gt, int(self.options["stack_pow2"]))

    def fused_spec(self):
        """Fused and generation campaigns take the plain havoc spec;
        the harness's ``grammar`` option carries the structure tables
        (one source of structure per campaign)."""
        return (self._seed_on_device(), self.seed_len, self._base_key(),
                int(self.options["stack_pow2"]))
