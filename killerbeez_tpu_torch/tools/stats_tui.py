"""kb-stats — live campaign view (curses-free ANSI TUI).

Tails a campaign's ``stats.jsonl`` (written by the fuzzer's telemetry
sink) or polls a manager's ``/api/stats/<campaign>`` fleet endpoint,
and redraws one compact dashboard frame per interval: exec rates
(lifetime + EMA), finding counts, new-path rate, corpus size and the
pipeline stage-time split.  No curses dependency — plain ANSI cursor
control, so it works over any ssh/tmux and degrades to sequential
frames when piped (``--once`` prints a single frame and exits).
Run as ``python -m killerbeez_tpu_torch.tools.stats_tui`` (``kb-stats``
below).

    kb-stats output/                         # local campaign
    kb-stats output/stats.jsonl --interval 2
    kb-stats --manager http://mgr:8650 --campaign 7   # fleet view
    kb-stats output/ --once --openmetrics    # Prometheus text format

``--once`` exits nonzero with a clear message when the campaign has
produced no stats yet, so scripts can gate on it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

from ..telemetry.metrics import STAGES, percentiles_from_counts
from ..telemetry.openmetrics import render_snapshot
from ..telemetry.sink import read_latest_snapshot as read_local

BAR_W = 40


def read_manager(url: str, campaign: str) -> Optional[Dict[str, Any]]:
    """Merged fleet snapshot from the manager stats endpoint."""
    try:
        with urllib.request.urlopen(
                f"{url}/api/stats/{campaign}", timeout=10) as resp:
            body = json.loads(resp.read())
        merged = body.get("merged")
        if merged is not None:
            merged["_n_workers"] = body.get("n_workers", 0)
        return merged
    except (OSError, ValueError):
        return None


def _fmt_n(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}" if v == int(v) else f"{v:.1f}"


def _bar(frac: float, width: int = BAR_W) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "-" * (width - n)


def _fmt_secs(v: float) -> str:
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}us"


def _stage_percentiles(snap: Dict[str, Any],
                       stage: str) -> Dict[str, float]:
    """p50/p99 for one stage: read from the snapshot when present
    (new registries emit them), else re-derive from the bucket
    counts (old snapshots)."""
    h = snap.get("hists", {}).get(stage)
    if not h:
        return {}
    if "p50" in h:
        return h
    return percentiles_from_counts(h.get("counts", []))


def render(snap: Dict[str, Any]) -> str:
    """One dashboard frame as a plain string (ANSI-free: the caller
    owns cursor control, tests own assertions)."""
    c = snap.get("counters", {})
    g = snap.get("gauges", {})
    d = snap.get("derived", {})
    r = snap.get("rates", {})
    elapsed = float(snap.get("elapsed", 0.0))
    lines: List[str] = []
    head = "kb-stats — campaign telemetry"
    if "_n_workers" in snap:
        head += f" ({snap['_n_workers']} workers, merged)"
    lines.append(head)
    lines.append("=" * len(head))
    lines.append(
        f"  run time : {int(elapsed) // 3600:02d}:"
        f"{int(elapsed) % 3600 // 60:02d}:{int(elapsed) % 60:02d}"
        f"    execs : {_fmt_n(c.get('execs', 0))}")
    lines.append(
        f"  execs/s  : {_fmt_n(d.get('execs_per_sec', 0.0))} lifetime"
        f" | {_fmt_n(d.get('execs_per_sec_ema', 0.0))} recent")
    seen = g.get("corpus_seen", g.get("corpus_size", 0))
    lines.append(
        f"  paths    : {_fmt_n(c.get('new_paths', 0))} total"
        f" | {r.get('new_paths', {}).get('rate', 0.0):.2f}/s recent"
        f" | corpus {_fmt_n(seen)} seen")
    if "corpus_arms" in g or "corpus_favored" in g \
            or c.get("corpus_synced_in") or c.get("corpus_synced_out"):
        line = (f"  corpus   : {int(g.get('corpus_arms', 0))} arms"
                f" | {int(g.get('corpus_favored', 0))} favored")
        if c.get("corpus_synced_in") or c.get("corpus_synced_out"):
            line += (f" | synced {_fmt_n(c.get('corpus_synced_in', 0))}"
                     f" in / {_fmt_n(c.get('corpus_synced_out', 0))}"
                     " out")
        lines.append(line)
    if c.get("gossip_rounds") or c.get("sync_quarantined") \
            or c.get("peers_banned"):
        line = (f"  gossip   : "
                f"{_fmt_n(c.get('gossip_entries_in', 0))} in / "
                f"{_fmt_n(c.get('gossip_entries_out', 0))} out"
                f" | {int(g.get('gossip_peers', 0))} peers"
                f" | {_fmt_n(c.get('gossip_rounds', 0))} rounds")
        if c.get("sync_quarantined"):
            line += (f" | {_fmt_n(c.get('sync_quarantined', 0))} "
                     "quarantined")
        if c.get("peers_banned") or g.get("peers_banned_active"):
            line += (f" | {int(g.get('peers_banned_active', 0))} "
                     f"banned ({_fmt_n(c.get('peers_banned', 0))} "
                     "lifetime)")
        lines.append(line)
    if c.get("hybrid_validations") or g.get("validation_queue_depth"):
        line = (f"  hybrid   : "
                f"{_fmt_n(c.get('hybrid_validations', 0))} validated"
                f" | {_fmt_n(c.get('hybrid_confirmed', 0))} confirmed"
                f" / {_fmt_n(c.get('hybrid_proxy_only', 0))} "
                f"proxy-only"
                f" / {_fmt_n(c.get('hybrid_flaky', 0))} flaky"
                f" | queue {int(g.get('validation_queue_depth', 0))}")
        if c.get("hybrid_proxy_gaps"):
            line += (f" | {_fmt_n(c.get('hybrid_proxy_gaps', 0))} "
                     "gap reports")
        lines.append(line)
    if c.get("repair_attempts"):
        line = (f"  repair   : "
                f"{_fmt_n(c.get('repair_attempts', 0))} attempts"
                f" | {_fmt_n(c.get('repair_repaired', 0))} repaired"
                f" / {_fmt_n(c.get('repair_unrepairable', 0))} "
                "unrepairable")
        if c.get("repair_errors"):
            line += f" | {_fmt_n(c.get('repair_errors', 0))} errors"
        lines.append(line)
    if c.get("solver_attempts") or g.get("solver_frontier"):
        line = (f"  solver   : "
                f"{_fmt_n(c.get('solver_solved', 0))} solved"
                f" | {_fmt_n(c.get('solver_unsat', 0))} unsat"
                f" | {_fmt_n(c.get('solver_unknown', 0))} unknown"
                f" | {int(g.get('solver_frontier', 0))} frontier "
                f"pending")
        if c.get("solver_injected"):
            line += f" | {_fmt_n(c.get('solver_injected', 0))} injected"
        lines.append(line)
    if c.get("search_attempts") or c.get("search_i2s_matches") \
            or g.get("descent_iterations_per_dispatch"):
        line = (f"  descent  : "
                f"{_fmt_n(c.get('search_descended', 0))} descended"
                f" | {_fmt_n(c.get('search_exhausted', 0))} exhausted"
                f" | {_fmt_n(c.get('search_attempts', 0))} attempts")
        if g.get("descent_iterations_per_dispatch"):
            line += (f" | {int(g.get('descent_iterations_per_dispatch', 0))} "
                     "iters/dispatch (device-resident)")
        if c.get("search_i2s_matches"):
            line += (f" | {_fmt_n(c.get('search_i2s_matches', 0))} "
                     "i2s matches")
        lines.append(line)
    if g.get("generations_per_dispatch"):
        line = (f"  genloop  : "
                f"{int(g.get('generations_per_dispatch', 0))} "
                f"generations/dispatch (device-resident)"
                f" | ring {int(g.get('gen_ring_filled', 0))} "
                f"slots filled")
        if c.get("findings_ring_drops"):
            line += (f" | {_fmt_n(c.get('findings_ring_drops', 0))} "
                     "findings-ring drops")
        lines.append(line)
    if g.get("learn_model_version") or c.get("learn_train_steps") \
            or g.get("learn_label_count"):
        line = (f"  learn    : model v{int(g.get('learn_model_version', 0))}"
                f" | {_fmt_n(g.get('learn_label_count', 0))} labels"
                f" | {_fmt_n(c.get('learn_train_steps', 0))} train "
                f"steps")
        if c.get("learn_masks_applied"):
            line += (f" | {_fmt_n(c.get('learn_masks_applied', 0))} "
                     "masks applied")
        lines.append(line)
    if g.get("state_cov_pairs"):
        lines.append(
            f"  stateful : "
            f"{int(g.get('state_cov_states', 0))} protocol states "
            f"seen | {_fmt_n(g.get('state_cov_pairs', 0))} "
            f"state x edge pairs covered")
    lines.append(
        f"  crashes  : {_fmt_n(c.get('crashes', 0))}"
        f" ({_fmt_n(c.get('unique_crashes', 0))} unique)"
        f"    hangs : {_fmt_n(c.get('hangs', 0))}"
        f" ({_fmt_n(c.get('unique_hangs', 0))} unique)"
        f"    errors : {_fmt_n(c.get('errors', 0))}")
    depth = g.get("pipeline_depth")
    if depth is not None:
        lines.append(f"  pipeline : {int(depth)} batches in flight")
    totals = {s: c.get(s + "_seconds", 0.0) for s in STAGES}
    acc = sum(totals.values())
    if acc > 0:
        lines.append("  stage split (host-attention seconds):")
        for s, t in sorted(totals.items(), key=lambda kv: -kv[1]):
            if t > 0:
                row = (f"    {s:<15} {_bar(t / acc)} "
                       f"{t / acc:6.1%}  ({t:.2f}s)")
                p = _stage_percentiles(snap, s)
                if p:
                    row += (f"  p50 {_fmt_secs(p['p50'])}"
                            f" p99 {_fmt_secs(p['p99'])}")
                lines.append(row)
    return "\n".join(lines)


def _frame(args) -> Optional[Dict[str, Any]]:
    if args.manager:
        return read_manager(args.manager, args.campaign)
    return read_local(args.path)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-stats",
        description="live campaign stats view (tails stats.jsonl or "
                    "polls a manager /api/stats endpoint)")
    p.add_argument("path", nargs="?", default="output",
                   help="campaign output dir or stats.jsonl path "
                        "(default ./output)")
    p.add_argument("--manager",
                   help="manager base URL (e.g. http://mgr:8650); "
                        "reads the merged fleet view instead of a "
                        "local file")
    p.add_argument("--campaign",
                   help="campaign key for --manager (job id)")
    p.add_argument("-i", "--interval", type=float, default=1.0,
                   help="refresh seconds (default 1)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (no ANSI)")
    p.add_argument("--json", action="store_true",
                   help="with --once: print the raw registry "
                        "snapshot as JSON (CI / scripts — no "
                        "rendering, no TTY assumptions)")
    p.add_argument("--openmetrics", action="store_true",
                   help="with --once: print the snapshot in the "
                        "OpenMetrics text format (the same renderer "
                        "behind the manager's /metrics; pipe to a "
                        "node_exporter textfile collector)")
    args = p.parse_args(argv)
    if args.manager and not args.campaign:
        print("error: --manager needs --campaign", file=sys.stderr)
        return 2
    if (args.json or args.openmetrics) and not args.once:
        print("error: --json/--openmetrics need --once",
              file=sys.stderr)
        return 2
    if args.json and args.openmetrics:
        print("error: --json and --openmetrics are mutually "
              "exclusive", file=sys.stderr)
        return 2
    if args.once:
        snap = _frame(args)
        # an empty dict is as useless as a missing file: scripts gate
        # on this exit, so "no campaign stats" must be LOUD, not an
        # all-zero report with exit 0
        if snap is None or not snap.get("counters"):
            if args.manager:
                print(f"error: no fleet stats for campaign "
                      f"{args.campaign!r} at {args.manager} (no "
                      f"worker heartbeat yet, or wrong campaign "
                      f"key)", file=sys.stderr)
            else:
                print(f"error: no campaign stats under {args.path!r} "
                      f"(stats.jsonl/fuzzer_stats missing or empty "
                      f"— is the fuzzer running with stats enabled, "
                      f"i.e. without --no-stats?)", file=sys.stderr)
            return 1
        if args.openmetrics:
            sys.stdout.write(render_snapshot(snap))
        else:
            print(json.dumps(snap) if args.json else render(snap))
        return 0
    try:
        while True:
            snap = _frame(args)
            # home + clear-to-end redraw (no flicker, no curses)
            sys.stdout.write("\x1b[H\x1b[J")
            sys.stdout.write(render(snap) if snap is not None
                             else "waiting for stats ...")
            sys.stdout.write("\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
