"""kb-zoo — the generated target zoo (models/zoo.py) CLI.

Families are parameterized KBVM program generators with planted,
certified deep bugs; instances resolve anywhere a ``--target`` is
taken, under ``zoo:family:k=v,...`` names.  Run as ``python -m
killerbeez_tpu_torch.tools.zoo_tool`` (``kb-zoo`` below); it runs on
the host (the static analysis and the solver's concrete interpreter).

Usage:
    kb-zoo list                       # families, knobs, gated names
    kb-zoo certify [names...]         # certify (default: gated set)
    kb-zoo certify --json             # machine-readable report
    kb-zoo generate zoo:tlv:depth=2,bug=1 --out DIR
        # write program.npz + seed + crash witness + grammar.json

``certify`` exits 1 when any requested instance fails certification
(lint errors, a non-benign seed, or a witness that does not crash
through the deep edge) — the CI zoo lane gates on this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from ..models.zoo import (
    GATED_NAMES, build_zoo, certify_zoo, zoo_families,
)


def _cmd_list(args) -> int:
    fams = zoo_families()
    print("zoo families (knob defaults):")
    for fam, params in sorted(fams.items()):
        knobs = ", ".join(f"{k}={v}" for k, v in sorted(params.items()))
        print(f"  {fam:8s} {knobs}")
    print("gated instances (bench --grammar / CI zoo lane):")
    for n in GATED_NAMES:
        print(f"  {n}")
    return 0


def _cmd_certify(args) -> int:
    names: List[str] = args.names or list(GATED_NAMES)
    reports = [certify_zoo(n) for n in names]
    ok = all(r["certified"] for r in reports)
    if args.json:
        print(json.dumps({"certified": ok, "targets": reports},
                         indent=2))
    else:
        for r in reports:
            mark = "ok " if r["certified"] else "FAIL"
            print(f"  {mark} {r['name']}: deep edge "
                  f"{tuple(r['deep_edge'])}, solver {r['solver']}, "
                  f"seed benign {r['seed_benign']}, witness crashes "
                  f"{r['witness_crashes']}, "
                  f"{len(r['lint_errors'])} lint error(s)")
        print("certified" if ok else "CERTIFICATION FAILED")
    return 0 if ok else 1


def _cmd_generate(args) -> int:
    import numpy as np

    t = build_zoo(args.name)
    os.makedirs(args.out, exist_ok=True)
    p = t.program
    np.savez(os.path.join(args.out, "program.npz"),
             instrs=np.asarray(p.instrs, dtype=np.int32),
             name=p.name, mem_size=p.mem_size, max_steps=p.max_steps,
             n_blocks=p.n_blocks,
             block_ids=np.asarray(p.block_ids, dtype=np.int64))
    with open(os.path.join(args.out, "seed"), "wb") as f:
        f.write(t.seed)
    with open(os.path.join(args.out, "crash"), "wb") as f:
        f.write(t.crash)
    with open(os.path.join(args.out, "grammar.json"), "w",
              encoding="utf-8") as f:
        f.write(t.grammar.to_json())
    report = certify_zoo(args.name)
    with open(os.path.join(args.out, "certificate.json"), "w",
              encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(f"{t.name} -> {args.out} (certified: "
          f"{report['certified']})")
    return 0 if report["certified"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kb-zoo", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="families, knobs, gated instances")
    c = sub.add_parser("certify", help="certify zoo instances")
    c.add_argument("names", nargs="*",
                   help="zoo:... names (default: the gated set)")
    c.add_argument("--json", action="store_true")
    g = sub.add_parser("generate", help="materialize one instance")
    g.add_argument("name", help="zoo:family:k=v,... instance name")
    g.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args(argv)
    return {"list": _cmd_list, "certify": _cmd_certify,
            "generate": _cmd_generate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
