"""picker — target determinism analysis + ignore-byte mask derivation.

The port of the JAX package's ``tools/picker.py`` (the reference
picker tool): run each seed ``-n`` times, classify the target's
coverage behavior (no-path / single-path / path-per-file /
multi-path-same-file) and emit a mask of bitmap bytes that vary across
repeated runs of the SAME input — the nondeterministic bytes an afl
instrumentation should exclude from novelty
(``{"ignore_bytes_file": ...}``).

The mask derivation is a pure array reduction (byte-wise variance
across [seeds, runs, MAP_SIZE]) on the host.  A KBVM target
(jit_harness) runs on ``--device`` (the card unless ``--device cpu``);
a stateful one adds the seeds' state x edge signatures.

Usage:
    python -m killerbeez_tpu_torch.tools.picker file afl \
        -d '{"path": "build/torch_native/corpus/test", "arguments": "@@"}' \
        -o mask.json seeds/a.bin seeds/b.bin
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

from ..ops.coverage import COUNT_CLASS_LOOKUP
from ..drivers.factory import driver_factory
from ..instrumentation.factory import instrumentation_factory
from ..utils.fileio import read_file, write_buffer_to_file
from ..utils.logging import INFO_MSG, setup_logging
from ..utils.serialization import encode_array

CLASS_NO_PATH = "no_path"
CLASS_SINGLE_PATH = "single_path"
CLASS_PATH_PER_FILE = "path_per_file"
CLASS_MULTI_PATH_SAME_FILE = "multi_path_same_file"


def collect_traces(driver, instrumentation, seeds: List[bytes],
                   num_iterations: int = 5) -> np.ndarray:
    """uint8[n_seeds, n_runs, MAP_SIZE] of classified bitmaps.

    The seeds x N-runs matrix executes as ONE batch through the C
    exec backend when the driver can describe a host-exec spec
    (stdin/file targets — the reference picker's nested loops
    collapsed into a single batch); other drivers fall back to
    per-exec calls."""
    if not hasattr(instrumentation, "last_trace"):
        raise ValueError(
            f"{instrumentation.name} does not expose raw bitmaps "
            "(picker needs an afl-style instrumentation)")
    batched = _collect_batched(driver, instrumentation, seeds,
                               num_iterations)
    if batched is not None:
        return batched
    rows = []
    for seed in seeds:
        runs = []
        for _ in range(num_iterations):
            driver.test_input(seed)
            trace = instrumentation.last_trace()
            if trace is None:
                raise ValueError("target produced no bitmap")
            runs.append(COUNT_CLASS_LOOKUP[trace])
        rows.append(np.stack(runs))
    return np.stack(rows)


def _collect_batched(driver, instrumentation, seeds: List[bytes],
                     num_iterations: int):
    """One exec-backend batch for the whole seeds x runs matrix;
    None when this driver/instrumentation pair can't batch host
    execs (network drivers, device backends)."""
    try:
        spec = driver._host_exec_spec()
        instrumentation.prepare_host(**spec)
        target = instrumentation._target
    except (NotImplementedError, AttributeError, KeyError):
        return None
    if target is None or not hasattr(target, "run_batch"):
        return None
    # determinism analysis must run every repeat of a seed through
    # ONE forkserver instance: across pool workers, address-space
    # differences would read as target nondeterminism (the reference
    # picker is likewise single-instance)
    if hasattr(target, "targets"):
        target = target.targets[0]
    from ..mutators.base import pack_byte_rows
    inputs, lens = pack_byte_rows(
        [s for s in seeds for _ in range(num_iterations)])
    _, bitmaps = target.run_batch(inputs, lens, want_bitmaps=True)
    if bitmaps is None:
        return None
    cls = COUNT_CLASS_LOOKUP[bitmaps]
    return cls.reshape(len(seeds), num_iterations, -1)


def derive_ignore_mask(traces: np.ndarray) -> np.ndarray:
    """Bytes that differ across repeated runs of the same seed
    (uint8[MAP_SIZE], 1 = nondeterministic -> ignore)."""
    varies = (traces != traces[:, :1, :]).any(axis=(0, 1))
    return varies.astype(np.uint8)


def classify_target(traces: np.ndarray) -> str:
    """The reference picker's 4-way module classification, applied to
    the whole target."""
    if not traces.any():
        return CLASS_NO_PATH
    stable = not (traces != traces[:, :1, :]).any()
    per_seed = traces[:, 0, :]
    all_same_across_seeds = bool(
        (per_seed == per_seed[:1]).all()) if len(per_seed) > 1 else True
    if not stable:
        return CLASS_MULTI_PATH_SAME_FILE
    if all_same_across_seeds:
        return CLASS_SINGLE_PATH
    return CLASS_PATH_PER_FILE


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-picker",
        description="classify target determinism and derive novelty "
                    "ignore masks")
    p.add_argument("driver", help="driver name (file, stdin, ...)")
    p.add_argument("instrumentation",
                   help="instrumentation name (afl, ...)")
    p.add_argument("seeds", nargs="+", help="seed input files")
    p.add_argument("-n", "--iterations", type=int, default=5,
                   help="runs per seed (default 5)")
    p.add_argument("-d", "--driver-options", help="driver JSON options")
    p.add_argument("-i", "--instrumentation-options",
                   help="instrumentation JSON options")
    p.add_argument("-o", "--output", required=True,
                   help="JSON report path ({classification, "
                        "ignore_bytes, nondeterministic_bytes})")
    p.add_argument("-l", "--logging-options", help="logging JSON options")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default: the card) or "cpu" (the plain '
                        "PyTorch versions)")
    args = p.parse_args(argv)
    try:
        setup_logging(args.logging_options)
        # device KBVM targets report raw bitmaps only with edge
        # recording on (jit_harness.last_trace; same forcing as
        # showmap/tracer — a no-op for host instrumentations)
        from .tracer import force_edges_option
        instrumentation = instrumentation_factory(
            args.instrumentation,
            force_edges_option(args.instrumentation_options),
            device=args.device)
        driver = driver_factory(args.driver, args.driver_options,
                                instrumentation, None, device=args.device)
        seeds = [read_file(s) for s in args.seeds]
        traces = collect_traces(driver, instrumentation, seeds,
                                args.iterations)
        mask = derive_ignore_mask(traces)
        report: Dict[str, object] = {
            "classification": classify_target(traces),
            "nondeterministic_bytes": int(mask.sum()),
            "ignore_bytes": encode_array(mask),
        }
        # KBVM targets carry an exact static universe: report it next
        # to the dynamic determinism analysis (a single_path verdict
        # over 3% of the static universe reads very differently from
        # one over 80%)
        program = getattr(instrumentation, "program", None)
        if program is not None:
            from ..analysis import build_cfg
            from ..analysis.lint import universe_stats
            report["static"] = universe_stats(program,
                                              build_cfg(program))
        # stateful session tier: the seeds' state x edge signatures
        # (which protocol states each seed drives and what it covers
        # from them) — the state-aware twin of the static section
        sig_fn = getattr(instrumentation, "state_signature", None)
        spec = getattr(instrumentation, "stateful_spec", None)
        if sig_fn is not None and spec is not None:
            per_seed = [sig_fn(s) for s in seeds]
            all_pairs = sorted({tuple(p) for sig in per_seed
                                for p in (sig or [])})
            report["state"] = {
                "n_states": int(spec.n_states),
                "m_max": int(spec.m_max),
                "state_reg": int(spec.state_reg),
                "states_reached": sorted({p[0] for p in all_pairs}),
                "pairs": [list(p) for p in all_pairs],
                "per_seed": [{"file": f, "pairs": sig or []}
                             for f, sig in zip(args.seeds, per_seed)],
            }
        # per-module report (the reference picker walks modules):
        # classification + partition-LOCAL ignore mask per
        # module; the top-level full-map mask stays the
        # ignore_bytes_file consumption format
        ranges = instrumentation.module_map_ranges()
        if ranges and len(ranges) > 1:  # single module: the top-level
            # fields ARE the per-module report; don't duplicate 64KB
            mods: Dict[str, object] = {}
            for name, lo, hi in ranges:
                sub = traces[:, :, lo:hi]
                sub_mask = derive_ignore_mask(sub)
                mods[name] = {
                    "classification": classify_target(sub),
                    "nondeterministic_bytes": int(sub_mask.sum()),
                    "ignore_bytes": encode_array(sub_mask),
                    "range": [int(lo), int(hi)],
                }
            report["modules"] = mods
        write_buffer_to_file(args.output,
                             json.dumps(report).encode())
        INFO_MSG("target is %s; %d nondeterministic bitmap bytes -> %s",
                 report["classification"],
                 report["nondeterministic_bytes"], args.output)
        for name, m in (report.get("modules") or {}).items():
            INFO_MSG("  module %s: %s, %d nondeterministic bytes",
                     name, m["classification"],
                     m["nondeterministic_bytes"])
        driver.cleanup()
        instrumentation.cleanup()
        return 0
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
