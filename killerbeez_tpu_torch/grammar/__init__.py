"""Structure-aware generation tier: grammar specs compiled to
fixed-shape device tables, and structured mutation in torch ops.

The port of the JAX package's ``grammar/``.  Layers:

* ``spec``   — the grammar spec model (rules / fields, JSON codec,
  the degenerate "anything" grammar);
* ``tables`` — the structure compiler: spec -> fixed-shape int32 /
  uint8 tables (``compile_grammar``), nesting inline-expanded to a
  depth cap with a one-shot clip warning;
* ``device`` — structured mutation (``grammar_havoc_at``), batched
  over lanes on the seed's device: field parse, token substitution,
  field-aware splice, subtree regeneration, length-field repair;
* ``derive`` — auto-derivation from the static layer
  (``derive_grammar``): dictionary tokens become literal runs and
  token alphabets, length-tainted compares mark length fields.

Parity doctrine: under the degenerate one-rule grammar the structured
mutation is bit-identical to blind ``havoc_at`` (same PRNG stream, same
edits), so the tier stands up without perturbing havoc's candidate
streams.
"""

from .spec import Field, Grammar, Rule, degenerate_grammar
from .tables import GrammarTables, compile_grammar
from .device import GRAMMAR_SALT, grammar_havoc_at, parse_fields
from .derive import derive_grammar

__all__ = [
    "Field", "Grammar", "Rule", "degenerate_grammar",
    "GrammarTables", "compile_grammar",
    "GRAMMAR_SALT", "grammar_havoc_at", "parse_fields",
    "derive_grammar",
]
