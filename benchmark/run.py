"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload tlvstack.fb --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout that holds ``killerbeez_tpu_torch``, on a
machine with as many CUDA cards as the cell asks for (else it exits 2
and prints no result).  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics and a breakdown from a
profiled stretch.  The kernel library builds into
``build/torch_kernels/`` (the first run in a checkout) and every cache
directory lies under ``build/bench_cache/``; the campaign's output goes
to a temporary directory under ``TMPDIR``, removed at the end.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _lived_before_start() -> float:
    """Seconds the process ran before this file's first line (the
    interpreter's start), from the kernel's start time of the
    process; 0 where it cannot be read."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(time.clock_gettime(time.CLOCK_BOOTTIME) - start
                   - (time.perf_counter() - T_START), 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def main() -> int:
    started = T_START - _lived_before_start()
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from kbbench import main as bench
    from kbbench import spec

    marks = {"interpreter": T_START, "imports": time.perf_counter()}
    cell = spec.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    marks["cuda"] = time.perf_counter()
    try:
        result, compared = bench.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            started=started, marks=marks)
    except bench.RunError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    bench.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
