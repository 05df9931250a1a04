"""kb-descend — gradient-guided search over the solver-unknown frontier.

The standalone face of ``search/descent.py``: run the exact solver
over a target's static universe, take the edges it honestly reports
``unknown`` (checksum loops, deep loop-carried state), and descend
their branch distances on the card — seeded from the solver's own
solved witnesses, chained so each cracked edge's witness seeds the
deeper ones.  Every reported witness is concretely verified to
traverse its edge (the same honesty contract as kb-solve).  Run as
``python -m killerbeez_tpu_torch.tools.descend_tool`` (``kb-descend``
below); ``--device cpu`` scores the candidates with the plain engine on
the CPU.

Usage:
    kb-descend imgparse_vm                    # the whole unknown set
    kb-descend tlvstack_vm --edge 12:13       # one edge
    kb-descend imgparse_vm --json --budget 24
    kb-descend imgparse_vm --require-cracked 8   # CI gate
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import numpy as np

from ..analysis.solver import solve_edge, unknown_kind
from ..search import (
    DEFAULT_DESCENT_BUDGET, DEFAULT_LANES, DEFAULT_SCAN_ITERS,
    descend_edge, descend_edge_device, seeds_reaching_block,
)
from .solve_tool import _load_program, _parse_edge

#: chained escalation passes: a cracked edge's witness re-seeds the
#: edges still pending (deep frontiers unlock level by level)
DEFAULT_ROUNDS = 3


def descend_report(program, edges: List[Tuple[int, int]],
                   seeds: List[bytes], *, budget: int, lanes: int,
                   rounds: int, intake: dict,
                   engine: str = "device",
                   scan_iters: int = DEFAULT_SCAN_ITERS,
                   device="cuda") -> dict:
    """Chained descent over ``edges``; the report carries per-round
    device-dispatch and candidate-evaluation counts (the
    machine-readable denominator the bench wall-clock gate divides
    by) alongside the per-edge verdicts."""
    out = {"target": program.name, "edges": {}, "cracked": 0,
           "exhausted": 0, "intake": intake, "engine": engine,
           "scan_iters": (scan_iters if engine == "device" else 1),
           "rounds": [], "dispatches": 0, "evals": 0}
    pending = list(edges)
    results = {}
    traces: dict = {}       # one reference replay per seed, shared
    for rnd in range(max(rounds, 1)):
        nxt = []
        r_disp = r_evals = r_cracked = 0
        for e in pending:
            se = seeds_reaching_block(program, seeds, e[0], cap=24,
                                      trace_cache=traces) \
                or seeds[:16]
            if engine == "device":
                r = descend_edge_device(program, e, se or [b"\x00"],
                                        budget=budget, lanes=lanes,
                                        scan_iters=scan_iters,
                                        trace_cache=traces,
                                        device=device)
            else:
                r = descend_edge(program, e, se or [b"\x00"],
                                 budget=budget, lanes=lanes,
                                 trace_cache=traces, device=device)
            results[e] = r
            r_disp += int(r.dispatches)
            r_evals += int(r.evals)
            if r.status == "descended":
                seeds.append(r.input)
                r_cracked += 1
            else:
                nxt.append(e)
        out["rounds"].append({"round": rnd, "attempted": len(pending),
                              "cracked": r_cracked,
                              "dispatches": r_disp, "evals": r_evals})
        out["dispatches"] += r_disp
        out["evals"] += r_evals
        if not nxt or len(nxt) == len(pending):
            break
        pending = nxt
    for e in edges:
        r = results[e]
        out["edges"][f"{e[0]}:{e[1]}"] = r.as_dict()
        out["cracked" if r.status == "descended" else "exhausted"] += 1
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-descend",
        description="branch-distance descent over the edges the "
                    "exact solver reports unknown (search/descent.py)")
    p.add_argument("target", nargs="?",
                   help="built-in target name (kb-lint lists them)")
    p.add_argument("--program-file",
                   help="compiled .npz program instead of a built-in")
    p.add_argument("--edge", action="append", type=_parse_edge,
                   metavar="F:T",
                   help="edge to descend as from:to block indices; "
                        "repeatable; default = every edge the solver "
                        "returns unknown on")
    p.add_argument("--block", type=int,
                   help="descend every unknown edge INTO this block")
    p.add_argument("--budget", type=int,
                   default=DEFAULT_DESCENT_BUDGET,
                   help="device dispatches per edge per round "
                        f"(default {DEFAULT_DESCENT_BUDGET})")
    p.add_argument("--lanes", type=int, default=DEFAULT_LANES,
                   help="candidate lanes per dispatch "
                        f"(default {DEFAULT_LANES})")
    p.add_argument("--engine", choices=("device", "host"),
                   default="device",
                   help="descent engine: 'device' (default) runs R "
                        "iterations per dispatch on the card "
                        "with input-to-state operand matching "
                        "(stands down to host per edge when "
                        "needed); 'host' forces the host-driven "
                        "engine")
    p.add_argument("--scan-iters", type=int,
                   default=DEFAULT_SCAN_ITERS, metavar="R",
                   help="device engine: iterations fused per "
                        f"dispatch (default {DEFAULT_SCAN_ITERS})")
    p.add_argument("--rounds", type=int, default=DEFAULT_ROUNDS,
                   help="chained escalation passes (a cracked edge's "
                        "witness seeds the rest; default "
                        f"{DEFAULT_ROUNDS})")
    p.add_argument("--seed-file", action="append", default=[],
                   help="extra population seed file (repeatable); "
                        "solver witnesses always ride along")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu" (the '
                        "plain engine)")
    p.add_argument("--require-cracked", type=int, metavar="N",
                   help="exit 1 unless at least N edges produced a "
                        "verified witness (the CI floor on the "
                        "checksum universes the exact solver provably "
                        "cannot solve)")
    args = p.parse_args(argv)
    try:
        program = _load_program(args)
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # intake: the exact solver runs first — descent only ever works
    # the frontier the exact tier could not crack
    universe = [(int(f), int(t)) for f, t in
                zip(np.asarray(program.edge_from),
                    np.asarray(program.edge_to))]
    seeds: List[bytes] = []
    unknown: List[Tuple[int, int]] = []
    intake = {"solved": 0, "unsat": 0, "unknown": 0,
              "unknown_kinds": {}}
    for e in universe:
        r = solve_edge(program, e)
        intake[r.status] += 1
        if r.status == "solved":
            seeds.append(r.input)
        elif r.status == "unknown":
            unknown.append(e)
            k = unknown_kind(r.reason)
            intake["unknown_kinds"][k] = \
                intake["unknown_kinds"].get(k, 0) + 1
    seeds = list(dict.fromkeys(seeds))
    for path in args.seed_file:
        try:
            with open(path, "rb") as f:
                seeds.append(f.read())
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    edges = list(args.edge or [])
    if args.block is not None:
        edges += [e for e in unknown if e[1] == args.block]
    if not edges:
        edges = list(unknown)
    edges = list(dict.fromkeys(edges))
    if not edges:
        print(f"{program.name}: the exact solver left no unknown "
              f"edges — nothing to descend")
        return 0

    rep = descend_report(program, edges, seeds, budget=args.budget,
                         lanes=args.lanes, rounds=args.rounds,
                         intake=intake, engine=args.engine,
                         scan_iters=args.scan_iters, device=args.device)
    ok = (args.require_cracked is None
          or rep["cracked"] >= args.require_cracked)

    if args.json:
        if args.require_cracked is not None:
            rep["require_cracked"] = args.require_cracked
            rep["require_met"] = ok
        print(json.dumps(rep, indent=2))
    else:
        print(f"{program.name}: {len(edges)} edge(s) beyond the "
              f"solver ceiling — {rep['cracked']} cracked, "
              f"{rep['exhausted']} exhausted "
              f"({rep['engine']} engine, {rep['dispatches']} "
              f"dispatches / {rep['evals']} evals; "
              f"intake: {intake['solved']} solved / "
              f"{intake['unknown']} unknown / {intake['unsat']} unsat)")
        for key, d in rep["edges"].items():
            if d["status"] == "descended":
                buf = bytes.fromhex(d["input_hex"])
                soft = " [soft-grad]" if d.get("soft_used") else ""
                soft += " [i2s]" if d.get("i2s") else ""
                print(f"  {key}: cracked in {d['steps']} iterations"
                      f" ({d.get('dispatches', d['steps'])} "
                      f"dispatches){soft} len={d['length']} {buf!r}")
            else:
                bd = d.get("best_dist")
                print(f"  {key}: exhausted ({d['steps']} iterations"
                      f" / {d.get('dispatches', d['steps'])} "
                      f"dispatches, best distance "
                      f"{'unreached' if bd is None else bd})")
        if args.require_cracked is not None and not ok:
            print(f"FAIL: {rep['cracked']} cracked < required "
                  f"{args.require_cracked}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
