"""Static analysis over KBVM programs (host numpy, copied from the JAX
package with the imports rewired):

  cfg.py       the block-level control-flow graph — reachability,
               dominators, loop headers, the longest loop-free path —
               and the static edge-frequency prior that primes
               ``--schedule rare-edge``
  dataflow.py  constant propagation and input-byte taint over the
               instruction graph; its branch-comparison constants are
               the ``dictionary`` mutator's automatic tokens
  solver.py    the path-condition solver the crack stage (``--crack``)
               and ``kb-solve`` run: concrete inputs for never-hit
               static edges, honest ``unsat``/``unknown`` verdicts
  vsa.py       the value-set fixpoint (``--vsa``): byte domains that
               seed the solver, and the infeasible-edge lint class
  priors.py    static per-position value histograms from the value sets
  lint.py      the ``kb-lint`` defect checks
  conformance.py  the hybrid tier's proxy-gap reports as
               counterexamples: parsing, replay clustering, blame on
               the diverging guard, and the ``kb-lint --gaps-dir``
               checks
  repair.py    verified proxy repair over the blamed guard (kb-repair,
               ``--auto-repair``): a patch is accepted only when the
               patched proxy agrees with the native tier on every
               counterexample and certification seed
"""

from .cfg import ControlFlowGraph, build_cfg, static_edge_prior
from .conformance import (
    BLAME_SCHEMA, GAP_SCHEMA, BlameRecord, GapParseError, GapReport,
    conformance_lint, load_gap_reports, localize, parse_gap_report,
    replay_gaps, verdict_class,
)
from .dataflow import (
    BranchFact, DataflowResult, analyze_dataflow,
    dictionary_candidates, extract_dictionary,
)
from .lint import Finding, lint_program
from .priors import PRIOR_SCHEMA, load_priors, save_priors, value_priors
from .repair import (
    REPAIR_SCHEMA, Patch, apply_patch, enumerate_patches, run_repair,
    save_patched_program, write_repair_ledger,
)
from .solver import (
    SolveResult, concrete_run, edge_dep_mask, solve_edge,
    solve_edge_vsa, solve_edges, vsa_seed_domains,
)
from .vsa import (
    VSA_SCHEMA, VDom, VsaFact, VsaResult, analyze_vsa, check_replay,
    program_sig, vsa_stats,
)

__all__ = [
    "ControlFlowGraph", "build_cfg", "static_edge_prior",
    "BranchFact", "DataflowResult", "analyze_dataflow",
    "dictionary_candidates", "extract_dictionary",
    "Finding", "lint_program",
    "SolveResult", "concrete_run", "edge_dep_mask", "solve_edge",
    "solve_edge_vsa", "solve_edges", "vsa_seed_domains",
    "VSA_SCHEMA", "VDom", "VsaFact", "VsaResult", "analyze_vsa",
    "check_replay", "program_sig", "vsa_stats",
    "PRIOR_SCHEMA", "value_priors", "save_priors", "load_priors",
    "GAP_SCHEMA", "BLAME_SCHEMA", "REPAIR_SCHEMA",
    "GapReport", "GapParseError", "BlameRecord", "Patch",
    "parse_gap_report", "load_gap_reports", "replay_gaps",
    "localize", "verdict_class", "conformance_lint",
    "apply_patch", "enumerate_patches", "run_repair",
    "save_patched_program", "write_repair_ledger",
]
