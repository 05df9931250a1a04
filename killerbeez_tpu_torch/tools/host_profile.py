"""Where the fuzz loop's host time goes: the port's CLI, in this
process, under cProfile.

    python -m killerbeez_tpu_torch.tools.host_profile [-b 65536] \
        [-n 1572864] [--target tlvstack_vm] [--runs 2] [--top 14] \
        [-fb N]

Runs ``file jit_harness havoc -m '{"seed": 3}'`` with engine cuda_fused
and throughput novelty on the target's built-in seed — the default
campaign (corpus feedback, stats files, events) unless ``-fb`` is
given — ``runs`` times in one process: the first run is cold (torch's
lazily loaded CUDA modules, the allocators, the kernel build), the
later ones warm.  For each run it prints the execs/s beside the card's
name and power limit, and for the last the functions that took the
most host time, then those matching ``--focus``.  Outputs
go to build/host_profile/ in the checkout.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..fuzzer.cli import main as cli_main
from ..models import targets_cgc

OUT = Path(__file__).resolve().parents[2] / "build" / "host_profile"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="host_profile",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("-b", type=int, default=65536, help="lanes per batch")
    p.add_argument("-n", type=int, default=3 * 8 * 65536,
                   help="executions per run")
    p.add_argument("--target", default="tlvstack_vm")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--top", type=int, default=14)
    p.add_argument("--focus", default=r"telemetry|corpus|resilience|"
                   r"_rotate_seed|_drain_ready|_credit_period|_upload|"
                   r"_admit_arm|_record",
                   help="regex of the functions to list by cumulative "
                        "time after the top list (default: the corpus "
                        "feedback and telemetry tiers)")
    p.add_argument("-fb", type=int, default=None,
                   help="the CLI's -fb (default: not given, so the "
                        "CLI's own default applies)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_profile: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    seed = OUT / "seed.bin"
    seed.write_bytes(getattr(targets_cgc, f"{a.target}_seed")())
    fb = [] if a.fb is None else ["-fb", str(a.fb)]
    argv = ["file", "jit_harness", "havoc", "-sf", str(seed), *fb,
            "-m", json.dumps({"seed": 3}), "-b", str(a.b), "-n", str(a.n),
            "-l", '{"level": 5}', "-o", str(OUT / "output"), "-i",
            json.dumps({"target": a.target, "engine": "cuda_fused",
                        "novelty": "throughput"})]
    for run in range(a.runs):
        shutil.rmtree(OUT / "output", ignore_errors=True)
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        rc = cli_main(argv)
        prof.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            print(f"host_profile: the CLI exited {rc}", file=sys.stderr)
            return rc
        print(f"run {run} ({'cold' if run == 0 else 'warm'}, -fb "
              f"{'default' if a.fb is None else a.fb}): {a.n} "
              f"execs in {wall:.3f} s = {a.n / wall:.0f} execs/s on "
              f"{card}", flush=True)
    report = ""
    for title, key, restrict in (
            ("top by own time", "tottime", ()),
            (f"functions matching {a.focus!r}, by cumulative time",
             "cumulative", (a.focus,))):
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats(key).print_stats(
            *restrict, a.top)
        report += text.getvalue()
        print(f"host time of the last run, {title}:")
        for line in text.getvalue().splitlines():
            if re.match(r"\s+\d", line):
                print("  " + line.strip()[:150])
    (OUT / "profile.txt").write_text(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
