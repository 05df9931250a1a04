"""minimize — greedy edge-cover working-set selection.

The port of the JAX package's ``tools/minimize.py`` (the reference
manager's minimizer, host Python): given the deterministic edge sets of
a corpus (tracer output files), repeatedly pick the input covering the
most still-uncovered edges until no input adds coverage.  The survivors
are the minimized working set.

Usage:
    python -m killerbeez_tpu_torch.tools.minimize -o keep.txt \
        edges/input_a.txt edges/input_b.txt ...
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..utils.logging import INFO_MSG, setup_logging
from .tracer import read_edge_file


def greedy_edge_cover(edge_sets: Dict[str, Set[int]]) -> List[str]:
    """Greedy set cover: returns the chosen keys in pick order.
    Deterministic: ties break on the lexically smallest key."""
    uncovered: Set[int] = set()
    for edges in edge_sets.values():
        uncovered |= edges
    chosen: List[str] = []
    remaining = dict(edge_sets)
    while uncovered and remaining:
        best_key, best_gain = None, 0
        for key in sorted(remaining):
            gain = len(remaining[key] & uncovered)
            if gain > best_gain:
                best_key, best_gain = key, gain
        if best_key is None:
            break
        chosen.append(best_key)
        uncovered -= remaining.pop(best_key)
    return chosen


def minimize_edge_files(paths: Iterable[str],
                        pairs: bool = False) -> Tuple[List[str], int]:
    """Greedy cover over tracer files; returns (kept paths, total
    distinct edges covered).  ``pairs=True`` reads the reference's
    from:to record format (tracer -f pairs) instead of slot:count."""
    if pairs:
        from .tracer import read_pair_file
        edge_sets = {p: read_pair_file(p) for p in paths}
    else:
        edge_sets = {p: set(read_edge_file(p).keys()) for p in paths}
    kept = greedy_edge_cover(edge_sets)
    covered = set().union(*(edge_sets[k] for k in kept)) if kept else set()
    return kept, len(covered)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-minimize",
        description="select a minimal working set by greedy edge cover")
    p.add_argument("edge_files", nargs="+",
                   help="tracer edge files, one per corpus input")
    p.add_argument("-o", "--output",
                   help="write kept file names here (default stdout)")
    p.add_argument("-p", "--pairs", action="store_true",
                   help="edge files are from:to pair records "
                        "(tracer -f pairs) instead of slot:count")
    p.add_argument("-l", "--logging-options", help="logging JSON options")
    args = p.parse_args(argv)
    try:
        setup_logging(args.logging_options)
        kept, covered = minimize_edge_files(args.edge_files, args.pairs)
        text = "".join(f"{k}\n" for k in kept)
        if args.output:
            from ..utils.fileio import write_buffer_to_file
            write_buffer_to_file(args.output, text.encode())
        else:
            sys.stdout.write(text)
        INFO_MSG("kept %d of %d inputs covering %d edges",
                 len(kept), len(args.edge_files), covered)
        return 0
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
