"""showmap — run one input, print its coverage map.

The port of the JAX package's ``tools/showmap.py`` (the reference's
afl-showmap): execute the target once on the given input and print the
nonzero map slots as ``slot:count`` lines; for KBVM targets the static
edge universe is logged beside them, and for a stateful instrumentation
the ``state:slot:count`` records of the session.

Usage (on the card; add ``--device cpu`` for the plain versions):
    python -m killerbeez_tpu_torch.tools.showmap file jit_harness \
        -sf input.bin -i '{"target": "tlvstack_vm"}'
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from ..analysis.cfg import build_cfg
from ..analysis.lint import universe_stats
from ..utils.fileio import read_file, write_buffer_to_file
from ..utils.logging import INFO_MSG, setup_logging
from .tracer import add_common_args, open_traced


def show_map(driver, instrumentation, input_bytes: bytes) -> List[str]:
    driver.test_input(input_bytes)
    edges = instrumentation.get_edges()
    if edges is None:
        raise ValueError(
            f"{instrumentation.name} cannot report coverage slots")
    return [f"{e}:{c}" for e, c in sorted(edges)]


def static_summary(program, dynamic_slots) -> str:
    """One line of static-universe context for a dynamic trace: how
    much of the statically enumerable edge universe this input lit."""
    s = universe_stats(program, build_cfg(program))
    static = set(int(x) for x in np.asarray(program.edge_slot))
    hit = len(static & set(int(d) for d in dynamic_slots))
    pct = 100.0 * hit / s["n_slots"] if s["n_slots"] else 0.0
    return (f"static universe: {s['n_blocks']} blocks, "
            f"{s['n_edges']} edges over {s['n_slots']} slots "
            f"({s['n_modules']} module(s)); input covered "
            f"{hit}/{s['n_slots']} static slots ({pct:.1f}%); "
            f"longest loop-free path {s['longest_acyclic_path']} of "
            f"max_steps {s['max_steps']}")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-showmap",
        description="run one input and print its coverage map")
    add_common_args(p)
    p.add_argument("-o", "--output",
                   help="write slot:count lines here (default stdout)")
    args = p.parse_args(argv)
    try:
        setup_logging(args.logging_options)
        driver, instrumentation = open_traced(args)
        lines = show_map(driver, instrumentation,
                         read_file(args.seed_file))
        # KBVM targets: the static edge universe next to the dynamic
        # trace (logged, so stdout stays slot:count parseable)
        program = getattr(instrumentation, "program", None)
        if program is not None:
            INFO_MSG("%s", static_summary(
                program, (int(ln.split(":")[0]) for ln in lines)))
        # stateful session tier: the input's state x edge record
        # (state:slot:count, logged so stdout stays slot:count
        # parseable for the classic consumers)
        sp_fn = getattr(instrumentation, "get_state_pairs", None)
        pairs = sp_fn() if sp_fn is not None else None
        if pairs:
            states = sorted({s for s, _, _ in pairs})
            INFO_MSG("state coverage: %d protocol state(s) %s, "
                     "%d state x edge pair(s): %s",
                     len(states), states, len(pairs),
                     " ".join(f"{s}:{e}:{c}" for s, e, c in pairs))
        text = "".join(f"{ln}\n" for ln in lines)
        if args.output:
            write_buffer_to_file(args.output, text.encode())
        else:
            sys.stdout.write(text)
        driver.cleanup()
        instrumentation.cleanup()
        return 0
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
