"""kb-solve — path-condition solving for KBVM program edges.

Given a target (built-in name or compiled ``.npz``) and an edge of
its static universe, print the concrete input the solver synthesized
to traverse it — or the honest unsat/unknown reason.  The CI smoke
lane drives ``--require-solved`` to fail the build when a previously-
solvable edge regresses.

Run as ``python -m killerbeez_tpu_torch.tools.solve_tool`` (``kb-solve``
below); the solver is host numpy, so nothing here touches the card.

Usage:
    kb-solve test                         # every static edge
    kb-solve tlvstack_vm --edge 4:5       # one edge (from:to, -1=entry)
    kb-solve cgc_like --block 7           # any edge into block 7
    kb-solve test --json --explain
    kb-solve test --require-solved 11     # CI gate
    kb-solve imgparse_vm --vsa --explain  # value-set seeding +
                                          # per-byte domain verdicts
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import numpy as np

from ..analysis.solver import (
    DEFAULT_BUDGET, DEFAULT_MAX_LEN, DEFAULT_MAX_VISITS, solve_edge,
)


def _parse_edge(s: str) -> Tuple[int, int]:
    try:
        f, t = s.split(":")
        return int(f), int(t)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"edge must be from:to block indices (-1 = entry), "
            f"got {s!r}")


def _load_program(args):
    from ..models import targets, targets_cgc  # noqa: F401
    if args.program_file:
        return targets.load_program_from_options(
            {"program_file": args.program_file}, "program_file missing")
    if not args.target:
        raise ValueError("a target name or --program-file is required")
    return targets.get_target(args.target)


def solve_report(program, edges, *, budget: int, max_visits: int,
                 max_len: int, explain: bool,
                 vsa: bool = False) -> dict:
    """The --json payload (and the CI smoke lane's data source).
    ``vsa=True`` routes every edge through ``solve_edge_vsa``
    (byte-domain seeding + the visit-cap escalation ladder) and
    attaches each verdict's ``vsa`` metadata; False (the default)
    keeps the report bit-identical to the pre-VSA tool."""
    out = {"target": program.name, "edges": {}, "solved": 0,
           "unsat": 0, "unknown": 0}
    vsa_doc = df = None
    if vsa:
        from ..analysis.dataflow import analyze_dataflow
        from ..analysis.solver import solve_edge_vsa
        from ..analysis.vsa import analyze_vsa
        vsa_doc = analyze_vsa(program)
        df = analyze_dataflow(program)
    for e in edges:
        if vsa:
            r = solve_edge_vsa(program, e, vsa=vsa_doc,
                               budget=budget, max_visits=max_visits,
                               max_len=max_len, dataflow=df)
        else:
            r = solve_edge(program, e, budget=budget,
                           max_visits=max_visits, max_len=max_len)
        d = r.as_dict()
        if not explain:
            d.pop("conditions", None)
        out["edges"][f"{e[0]}:{e[1]}"] = d
        out[r.status] += 1
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-solve",
        description="solve path conditions of KBVM static edges into "
                    "concrete inputs (analysis/solver.py)")
    p.add_argument("target", nargs="?",
                   help="built-in target name (kb-lint lists them)")
    p.add_argument("--program-file",
                   help="compiled .npz program instead of a built-in")
    p.add_argument("--edge", action="append", type=_parse_edge,
                   metavar="F:T",
                   help="edge to solve as from:to block indices "
                        "(-1 = entry); repeatable; default = every "
                        "edge of the static universe")
    p.add_argument("--block", type=int,
                   help="solve every edge INTO this block index")
    p.add_argument("--budget", type=int, default=DEFAULT_BUDGET,
                   help="path-search expansion budget per edge "
                        f"(default {DEFAULT_BUDGET})")
    p.add_argument("--max-visits", type=int,
                   default=DEFAULT_MAX_VISITS,
                   help="per-pc visit cap on candidate paths (loop "
                        f"unrolling depth; default {DEFAULT_MAX_VISITS})")
    p.add_argument("--max-len", type=int, default=DEFAULT_MAX_LEN,
                   help="synthesized input length cap "
                        f"(default {DEFAULT_MAX_LEN})")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout")
    p.add_argument("--vsa", action="store_true",
                   help="seed byte domains from the value-set "
                        "fixpoint and escalate visit caps on honest "
                        "visit-cap unknowns (analysis/vsa.py)")
    p.add_argument("--explain", action="store_true",
                   help="print the collected path condition of each "
                        "solved edge; with --vsa, also the VSA "
                        "domain that pruned (or failed to prune) "
                        "each free byte of unknown edges")
    p.add_argument("--require-solved", type=int, metavar="N",
                   help="exit 1 unless at least N edges solved (the "
                        "CI smoke gate: a previously-solvable edge "
                        "going dark fails the lane)")
    args = p.parse_args(argv)
    try:
        program = _load_program(args)
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    universe = [(int(f), int(t)) for f, t in
                zip(np.asarray(program.edge_from),
                    np.asarray(program.edge_to))]
    edges = list(args.edge or [])
    if args.block is not None:
        edges += [e for e in universe if e[1] == args.block]
    if not edges:
        edges = universe
    edges = list(dict.fromkeys(edges))  # dedupe: repeated --edge /
    # --block overlaps must not double-count toward --require-solved

    rep = solve_report(program, edges, budget=args.budget,
                       max_visits=args.max_visits,
                       max_len=args.max_len, explain=args.explain,
                       vsa=args.vsa)
    ok = (args.require_solved is None
          or rep["solved"] >= args.require_solved)

    if args.json:
        if args.require_solved is not None:
            rep["require_solved"] = args.require_solved
            rep["require_met"] = ok
        print(json.dumps(rep, indent=2))
    else:
        print(f"{program.name}: {len(edges)} edge(s) — "
              f"{rep['solved']} solved, {rep['unsat']} unsat, "
              f"{rep['unknown']} unknown")
        for key, d in rep["edges"].items():
            if d["status"] == "solved":
                buf = bytes.fromhex(d["input_hex"])
                print(f"  {key}: solved len={d['length']} {buf!r}")
                if args.explain:
                    for c in d.get("conditions", []):
                        print(f"      {c}")
            else:
                print(f"  {key}: {d['status']} ({d['reason']})")
            if args.explain and d.get("vsa"):
                v = d["vsa"]
                if v.get("visit_ladder"):
                    print(f"      vsa: visit ladder "
                          f"{v['visit_ladder']}, seeded bytes "
                          f"{v.get('seeded_bytes', [])}")
                for var, desc in sorted(
                        v.get("domains", {}).items()):
                    print(f"      vsa: {var}: {desc}")
                if v.get("certificate"):
                    c = v["certificate"]
                    print(f"      vsa: unsat certificate — "
                          f"exhaustive at max_visits="
                          f"{c['max_visits']}, "
                          f"{c['expansions']} expansions, "
                          f"{len(c['forced_guards'])} forced "
                          f"guard(s)")
        if args.require_solved is not None and not ok:
            print(f"FAIL: {rep['solved']} solved < required "
                  f"{args.require_solved}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
