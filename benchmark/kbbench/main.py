"""One run of one cell: set-up, window, check, metrics, result line."""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import arith, campaign, check, devtrace, readers, spec, stats
from reference import prng

FORBIDDEN = ("jax", "jaxlib", "flax", "killerbeez_tpu")


class RunError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (``killerbeez_tpu_torch`` is neither: names compare
    whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def stretch_bound(ctx: check.Context, stretch, L: int):
    """(the least seconds the chip needs for the profiled dispatches'
    batches, what bounds it: "bytes" or "operations"), ``arith``."""
    prog = ctx.prog
    n_slots = int(ctx.u_slots.shape[0])
    table = prog.instrs.size * 4 + prog.edge_table.size * (
        1 if prog.n_edges < 256 else 4)
    ops = nbytes = 0
    for d in stretch:
        if len(d.vm) != d.k:
            return None
        for j, (steps, counts) in enumerate(d.vm):
            its = (d.it0 + j * d.n
                   + torch.arange(d.n, dtype=torch.int64,
                                  device=ctx.dev)) & 0xFFFFFFFF
            words = prng.havoc_words(ctx.key, its, ctx.stack_pow2)
            ops += (arith.havoc_ops(words, ctx.stack_pow2, L)
                    + arith.vm_ops(steps, counts)
                    + arith.triage_ops(d.n, prog.n_edges, n_slots))
            nbytes += arith.batch_bytes(d.n, L, table, prog.map_size)
    return arith.bound_seconds(nbytes, ops) if stretch else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: Optional[float] = None,
             prepare: Optional[Callable] = None,
             log: Callable[[str], None] = print,
             control: bool = False, tiny: Optional[Dict[str, int]] = None,
             marks: Optional[Dict[str, float]] = None
             ) -> Tuple[Dict[str, Any], List[Tuple[str, int, int]]]:
    """Run cell ``name`` once.  Returns (the result object, the numbers
    compared as (name, value, limit)).  ``control`` adds the control's
    verdict on the same dispatches, with the control's outputs in the
    program's place (``control.py``; no benchmark run computes it).
    ``device``, ``prepare`` (called with the built ``Fuzzer``) and
    ``tiny`` (``lanes`` and ``warmup_steps``) serve the CPU tests,
    which run the harness at a tiny size.  ``marks`` holds host clocks
    of set-up's first stages (``run.py``), reported part by part."""
    started = time.perf_counter() if started is None else started
    cell = spec.load_cell(name)
    cfg, tr = cell.config, cell.traffic
    for key, v in (tiny or {}).items():
        (cfg if key == "lanes" else tr)[key] = v
    out_dir = tempfile.mkdtemp(prefix="kbbench-")
    try:
        iopts = campaign.instrumentation_options(
            cfg, tr, str(spec.bench_path(cfg["program"])))
        argv = campaign.cli_argv(
            cfg, tr, seed, out_dir, campaign.write_seed(out_dir,
                                                        cfg["seed_hex"]),
            iopts, device)
        win = campaign.Window(seconds, tr["warmup_steps"],
                              tr.get("profile_steps", 3),
                              campaign.sample_frac(seed), trace)
        camp = campaign.Campaign(argv, win, device, prepare)
        rc = camp.run()
        if rc != 0:
            raise RunError(f"the campaign exited {rc}; see its log")
        if win.t_snap1 is None:
            raise RunError("the window never closed: the campaign ended "
                           f"after {win.n_steps} steps")
        if win.sample is None or win.sample.after is None or \
                win.start is None or win.start.after is None:
            raise RunError("no dispatch was captured for the check")
        events = camp.stop_profiler()
        bad = forbidden_modules()
        if bad:
            raise RunError("loaded after the window: " + ", ".join(bad))
        setup_s = win.t0 - started
        parts = setup_parts(dict(marks or {}, **win.marks, window=win.t0),
                            started)
        camp.fuzzer = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # the check, on the tensors' device, after the window
        ctx = check.Context(
            iopts["program_file"], bytes.fromhex(cfg["seed_hex"]),
            int(seed) & 0xFFFFFFFF,
            int(cfg.get("mutator_options", {}).get("stack_pow2", 4)),
            device, out_dir + "/campaign", iopts)
        t_check = time.perf_counter()
        readings, info = check.run_checks(ctx, tr["check"], win.start,
                                          win.sample)
        info["check_s"] = time.perf_counter() - t_check
        compared = [(k, int(readings[k]), 0) for k in check.NAMES]
        ctl = None
        if control:
            ctl = check.run_checks(ctx, tr["check"], win.start, win.sample,
                                   control=True)[0]
            ctl = {"correct": all(ctl[k] <= lim for k, _, lim in compared),
                   "checks": {k: {"value": int(ctl[k]), "limit": lim}
                              for k, _, lim in compared}}

        stretch = bound = None
        if events is not None:
            stretch = devtrace.reduce(events, win.stages, win.calibration_ns)
            if stretch is not None:
                bound = stretch_bound(ctx, win.stretch,
                                      win.sample.before["L"])
        r = readers.Reading(win, cell, setup_s, stretch,
                            bound[0] if bound else None)
        metrics = readers.read_all(cell.per_layer if trace
                                   else cell.end_to_end, r)
        files, nbytes = campaign.tree_size(out_dir)
        steps = len(campaign_steps(win))
        shares = " ".join(
            f"{s} {r.stage_share(s):.2f}%" for s in
            ("host_transfer", "triage", "fs_write", "corpus_feedback",
             "execute", "mutate"))
        log(f"kbbench: {name} seed {seed}: {steps} steps in the "
            f"{seconds:g} s window, {win.window_dispatches} dispatches; "
            f"set-up {setup_s:.3f} s ({parts}); check "
            f"{info['check_s']:.3f} s over {info['checked_lanes']} lanes, "
            f"{info['expected_findings']} findings; wrote {files} files, {nbytes} bytes; host stages "
            f"in the window: {shares}"
            + (f"; the stretch's work is bound by {bound[1]}" if bound
               else ""))
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else device),
               "count": 1, "memory_peak_bytes": int(win.memory_peak)}
        result: Dict[str, Any] = {
            "correct": all(v <= lim for _, v, lim in compared),
            "attempted": campaign_execs(win),
            "failed": int(r.counter_delta("errors")),
            "metrics": metrics, "device": dev}
        if stretch is not None:
            dev["busy_s"] = stretch.busy_ns * 1e-9
            dev["window_s"] = stretch.window_ns * 1e-9
            result["breakdown"] = devtrace.breakdown(stretch)
        if device == "cuda":
            result["card"] = card_line()
        if ctl is not None:
            result["control"] = ctl
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, v, lim in compared}
        return result, compared
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


SETUP_STAGES = ("interpreter", "imports", "cuda", "built",
                "first_dispatch", "window")


def setup_parts(marks: Dict[str, float], started: float) -> str:
    """Set-up's seconds by stage, each from the previous mark: the
    interpreter's start, the imports, the CUDA context, the campaign
    built by the CLI, its first dispatch back on the host (the kernel
    library loaded, and built on a checkout's first run), the rest of
    the warm-up."""
    out, last = [], started
    for k in SETUP_STAGES:
        if k in marks:
            out.append(f"{k} {marks[k] - last:.3f}")
            last = marks[k]
    return ", ".join(out)


def campaign_steps(win) -> List[float]:
    return stats.step_intervals(win.step_ends, win.t0, win.t1)


def campaign_execs(win) -> int:
    return stats.execs_in_window(win.dispatched, win.t0, win.t1)


def emit(result: Dict[str, Any], compared) -> None:
    """The result line last on standard output, each compared number
    with its limit last on standard error."""
    for k, v, lim in compared:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
