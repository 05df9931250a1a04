"""Static analysis over KBVM programs (host numpy, copied from the JAX
package): ``cfg.py`` rebuilds the block-level control-flow graph —
reachability, dominators, loop headers, the longest loop-free path —
and the static edge-frequency prior that primes ``--schedule
rare-edge``; ``dataflow.py`` runs constant propagation and input-byte
taint over the instruction graph, whose branch-comparison constants
are the ``dictionary`` mutator's automatic tokens."""

from .cfg import ControlFlowGraph, build_cfg, static_edge_prior
from .dataflow import dictionary_candidates, extract_dictionary

__all__ = ["ControlFlowGraph", "build_cfg", "dictionary_candidates",
           "extract_dictionary", "static_edge_prior"]
