"""Static analysis over KBVM programs (host numpy, copied from the JAX
package): ``cfg.py`` rebuilds the block-level control-flow graph —
reachability, dominators, loop headers, the longest loop-free path —
and the static edge-frequency prior that primes ``--schedule
rare-edge``."""

from .cfg import ControlFlowGraph, build_cfg, static_edge_prior

__all__ = ["ControlFlowGraph", "build_cfg", "static_edge_prior"]
