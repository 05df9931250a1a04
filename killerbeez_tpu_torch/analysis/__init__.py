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

The conformance and repair modules wait for the hybrid tier.
"""

from .cfg import ControlFlowGraph, build_cfg, static_edge_prior
from .dataflow import (
    BranchFact, DataflowResult, analyze_dataflow,
    dictionary_candidates, extract_dictionary,
)
from .lint import Finding, lint_program
from .priors import PRIOR_SCHEMA, load_priors, save_priors, value_priors
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
]
