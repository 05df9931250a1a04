"""tracer — harvest the deterministic edge set of one input.

The port of the JAX package's ``tools/tracer.py`` (the reference's
tracer tool): run one input ``-n`` times (default 5) with the
instrumentation forced into edges mode, keep only the edges observed
in EVERY run (the deterministic set), and write them as ``edge:count``
text lines — or, with ``-f pairs``, the reference's ``from:to``
records, one file per module.

Usage (on the card; add ``--device cpu`` for the plain versions):
    python -m killerbeez_tpu_torch.tools.tracer file jit_harness \
        -sf input.bin -i '{"target": "tlvstack_vm"}' -o edges.txt
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ..drivers.factory import driver_factory
from ..instrumentation.factory import instrumentation_factory
from ..utils.fileio import read_file, write_buffer_to_file
from ..utils.logging import INFO_MSG, setup_logging


def force_edges_option(options: Optional[str]) -> str:
    """Merge {"edges": 1} into an instrumentation option string (the
    reference tracer forces the same)."""
    opts = json.loads(options) if options else {}
    opts["edges"] = 1
    return json.dumps(opts)


def trace_deterministic_edges(driver, instrumentation,
                              input_bytes: bytes,
                              num_iterations: int = 5
                              ) -> Dict[int, int]:
    """Run the input ``num_iterations`` times; return {edge_id: min hit
    count} for the edges present in every run."""
    counts: Optional[Dict[int, int]] = None
    for _ in range(num_iterations):
        driver.test_input(input_bytes)
        edges = instrumentation.get_edges()
        if edges is None:
            raise ValueError(
                f"{instrumentation.name} cannot report edges "
                "(needs edges mode support)")
        run = dict(edges)
        if counts is None:
            counts = run
        else:
            counts = {e: min(c, run[e])
                      for e, c in counts.items() if e in run}
    return counts or {}


def trace_deterministic_pairs(driver, instrumentation,
                              input_bytes: bytes,
                              num_iterations: int = 5):
    """Per-module (from, to) records present in every run: one target
    execution per iteration, all modules harvested from the same run.
    Returns {module_name: {(from_id, to_id), ...}}."""
    modules = instrumentation.get_module_info() or ["target"]
    per_mod = None
    for _ in range(num_iterations):
        driver.test_input(input_bytes)
        run: Dict[str, set] = {}
        for module in modules:
            rec = instrumentation.get_edge_pairs(module)
            if rec is None:
                raise ValueError(
                    f"{instrumentation.name} cannot report (from, to) "
                    "edge records (needs a static edge universe)")
            run[module] = {(f, t) for f, t, _ in rec}
        if per_mod is None:
            per_mod = run
        else:
            per_mod = {m: per_mod[m] & run[m] for m in modules}
    return per_mod or {}


def write_edge_file(path: str, edges: Dict[int, int]) -> None:
    text = "".join(f"{e}:{c}\n" for e, c in sorted(edges.items()))
    write_buffer_to_file(path, text.encode())


def write_pair_file(path: str, pairs) -> None:
    """The reference's text edge format: one ``from:to`` line per
    edge."""
    text = "".join(f"{f}:{t}\n" for f, t in sorted(pairs))
    write_buffer_to_file(path, text.encode())


def read_pair_file(path: str):
    """{(from, to), ...} from a reference-format edge file."""
    pairs = set()
    for line in read_file(path).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        f, t = line.split(":")
        pairs.add((int(f), int(t)))
    return pairs


def read_edge_file(path: str) -> Dict[int, int]:
    """{edge: count} from an ``edge:count`` file (the minimizer's
    input)."""
    edges: Dict[int, int] = {}
    for line in read_file(path).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        e, c = line.split(":")
        edges[int(e)] = int(c)
    return edges


def open_traced(args):
    """(driver, instrumentation) for a tool's argv: the instrumentation
    with edges forced on, on ``args.device``."""
    instrumentation = instrumentation_factory(
        args.instrumentation,
        force_edges_option(args.instrumentation_options),
        device=args.device)
    driver = driver_factory(args.driver, args.driver_options,
                            instrumentation, None, device=args.device)
    return driver, instrumentation


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The driver/instrumentation/seed arguments tracer and showmap
    share."""
    p.add_argument("driver", help="driver name (file)")
    p.add_argument("instrumentation",
                   help="instrumentation name (jit_harness)")
    p.add_argument("-sf", "--seed-file", required=True,
                   help="the input to trace")
    p.add_argument("-d", "--driver-options", help="driver JSON options")
    p.add_argument("-i", "--instrumentation-options",
                   help="instrumentation JSON options (edges forced on)")
    p.add_argument("-l", "--logging-options",
                   help="logging JSON options")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu" (the plain '
                        "PyTorch versions)")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-tracer",
        description="dump the deterministic edge set of one input")
    add_common_args(p)
    p.add_argument("-n", "--iterations", type=int, default=5,
                   help="runs to intersect (default 5)")
    p.add_argument("-o", "--output", required=True,
                   help="edge file to write (edge:count lines; pairs "
                        "mode appends .<module> with >1 module)")
    p.add_argument("-f", "--format", choices=("slots", "pairs"),
                   default="slots",
                   help='"slots" = slot:count lines; "pairs" = the '
                        "reference's from:to text records, one file per "
                        "module")
    args = p.parse_args(argv)
    try:
        setup_logging(args.logging_options)
        driver, instrumentation = open_traced(args)
        data = read_file(args.seed_file)
        if args.format == "pairs":
            per_mod = trace_deterministic_pairs(
                driver, instrumentation, data, args.iterations)
            for module, pairs in per_mod.items():
                out = args.output if len(per_mod) == 1 else \
                    f"{args.output}.{module}"
                write_pair_file(out, pairs)
                INFO_MSG("%s: %d deterministic edges (of %d runs) -> %s",
                         module, len(pairs), args.iterations, out)
        else:
            edges = trace_deterministic_edges(
                driver, instrumentation, data, args.iterations)
            write_edge_file(args.output, edges)
            INFO_MSG("%d deterministic edges (of %d runs) -> %s",
                     len(edges), args.iterations, args.output)
        driver.cleanup()
        instrumentation.cleanup()
        return 0
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
