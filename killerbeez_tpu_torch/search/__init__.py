"""Gradient-guided search over KBVM branch distances.

The third coverage tier, picking up where the exact layers stop:

  static analysis (``analysis/``) — describes every branch;
  exact solver (``analysis/solver.py``) — solves the described
                            conditions, honest ``unknown`` on
                            checksum-style loops;
  search (this package)   — descends the unknowns: Angora-style
                            branch-distance minimization with the
                            objective evaluated for thousands of
                            candidates per device dispatch.

  objective.py  deciding-branch extraction: which OP_BR (and which
                direction) a frontier edge needs, as the specs of
                ``vm.run_batch_distances``
  descent.py    the host-driven descent engine: elite front,
                coordinate probes, ES mutants, recombination,
                restarts — each population scored on the device — and
                the verified-witness honesty contract
  soft.py       float32-relaxed soft-KBVM: a ``torch.autograd``
                gradient through arithmetic-only path slices,
                proposals only
  device_descent.py  the device engine: R rank -> probe -> mutate ->
                re-score iterations per dispatch with the carry held
                in device tensors, plus Redqueen-style input-to-state
                operand matching off the captured compare operands

Consumers: the crack stage's escalation path (``fuzzer/crack.py``,
``--descend``) and the ``kb-descend`` tool
(``python -m killerbeez_tpu_torch.tools.descend_tool``).
"""

from .descent import (
    DEFAULT_DESCENT_BUDGET, DEFAULT_LANES, DescentResult, descend_edge,
    seeds_reaching_block,
)
from .device_descent import (
    DEFAULT_SCAN_ITERS, DeviceDescent, descend_edge_device,
)
from .objective import BranchObjective, edge_objectives
from .soft import SoftSlice, soft_refine, trace_slice

__all__ = [
    "DEFAULT_DESCENT_BUDGET", "DEFAULT_LANES", "DescentResult",
    "descend_edge", "seeds_reaching_block",
    "DEFAULT_SCAN_ITERS", "DeviceDescent", "descend_edge_device",
    "BranchObjective", "edge_objectives",
    "SoftSlice", "soft_refine", "trace_slice",
]
