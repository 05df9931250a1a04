"""The control of a cell's check, on the chip at the cell's own size.

    python3 benchmark/control.py --workload tlvstack.fb \\
        --seeds 11,12,13 --seconds 4

For each seed: one run of the cell with a short window, then its check
twice on the same checked dispatches: once of the program, and once of
the control in the program's place, through the same comparison and
limits.  The control is the reference with one of the configuration's
guarantees broken: every lane stopped at the phase-1 budget of
max_steps / 8, the step a two-phase schedule would tempt a change to
end at.  One JSON line per seed, with each side's ``correct``; the
control's has to be false.  The benchmark's own runs never compute the
control.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    import argparse
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    import torch
    from kbbench import main as bench
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = bench.run_cell(args.workload, seed, args.seconds,
                                   False, control=True,
                                   log=lambda s: print(s, file=sys.stderr))
        ctl = result["control"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"],
            "control_correct": ctl["correct"],
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": {k: v["value"] for k, v in ctl["checks"].items()},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "card": result.get("card")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
