"""merger — fold N serialized instrumentation states into one.

The port of the JAX package's ``tools/merger.py`` (the reference's
merger tool): load each state file, fold ``instrumentation.merge``
over them, and dump the combined state.  This is the offline,
cross-host coverage "allreduce"; the on-line equivalent is the mesh's
dp AND-fold in ``parallel.distributed``.  A device instrumentation
(jit_harness) folds on ``--device`` (the card unless ``--device cpu``).

Usage:
    python -m killerbeez_tpu_torch.tools.merger afl -o merged.state \
        node0.state node1.state node2.state
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..instrumentation.factory import instrumentation_factory
from ..utils.fileio import read_file, write_buffer_to_file
from ..utils.logging import INFO_MSG, setup_logging


def merge_state_files(instrumentation_name: str,
                      instrumentation_options: Optional[str],
                      state_files: List[str], device="cuda") -> str:
    """Fold the states in ``state_files`` left-to-right; returns the
    combined serialized state."""
    if not state_files:
        raise ValueError("merger needs at least one state file")
    instr = instrumentation_factory(instrumentation_name,
                                    instrumentation_options, device=device)
    try:
        instr.set_state(read_file(state_files[0]).decode())
        for path in state_files[1:]:
            instr.merge(read_file(path).decode())
        return instr.get_state()
    finally:
        instr.cleanup()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-merger",
        description="merge serialized instrumentation states")
    p.add_argument("instrumentation", help="instrumentation name (afl, ...)")
    p.add_argument("states", nargs="+", help="state files to merge")
    p.add_argument("-i", "--instrumentation-options",
                   help="instrumentation JSON options")
    p.add_argument("-o", "--output", required=True,
                   help="write the merged state here")
    p.add_argument("-l", "--logging-options", help="logging JSON options")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu" (the plain '
                        "PyTorch versions)")
    args = p.parse_args(argv)
    try:
        setup_logging(args.logging_options)
        merged = merge_state_files(args.instrumentation,
                                   args.instrumentation_options,
                                   args.states, args.device)
        write_buffer_to_file(args.output, merged.encode())
        INFO_MSG("merged %d states -> %s", len(args.states), args.output)
        return 0
    except (ValueError, FileNotFoundError, NotImplementedError,
            RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
