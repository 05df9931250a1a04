"""kb-fleet — fleet observatory console (afl-whatsup, one level up).

Polls a manager's ``/api/fleet`` endpoints and renders the fleet the
way kb-stats renders one campaign: a per-worker health/rate table
(who is healthy/stale/dead, how fast each worker is going, who found
what), fleet totals from the merged snapshot, and the alert
evaluator's current states.  Plain ANSI like kb-stats — works over
any ssh/tmux, degrades to sequential frames when piped.  Run as
``python -m killerbeez_tpu_torch.tools.fleet_tool`` (``kb-fleet``
below).

    kb-fleet http://mgr:8650                      # campaigns index
    kb-fleet http://mgr:8650 --campaign 7         # health/rate table
    kb-fleet http://mgr:8650 --campaign 7 --watch # live redraw
    kb-fleet http://mgr:8650 --campaign 7 --json  # raw API body
    kb-fleet http://mgr:8650 --campaign 7 --plot-data > fleet_plot
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional


def _get(url: str) -> Any:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _fmt_n(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}" if v == int(v) else f"{v:.1f}"


def _fmt_age(s: float) -> str:
    if s >= 3600:
        return f"{s / 3600:.1f}h"
    if s >= 60:
        return f"{s / 60:.1f}m"
    return f"{s:.1f}s"


def render_index(body: Dict[str, Any], url: str) -> str:
    lines = [f"kb-fleet — campaigns @ {url}"]
    lines.append("=" * len(lines[0]))
    campaigns = body.get("campaigns", {})
    if not campaigns:
        lines.append("  (no campaigns have heartbeated yet)")
    for name, c in sorted(campaigns.items()):
        lines.append(
            f"  {name:<16} {c.get('n_workers', 0)} workers "
            f"({c.get('healthy', 0)} healthy / "
            f"{c.get('stale', 0)} stale / {c.get('dead', 0)} dead)")
    return "\n".join(lines)


def render_fleet(body: Dict[str, Any], url: str) -> str:
    lines: List[str] = []
    head = f"kb-fleet — campaign {body.get('campaign')} @ {url}"
    lines.append(head)
    lines.append("=" * len(head))
    counts = body.get("counts", {})
    cfg = body.get("config", {})
    lines.append(
        f"  workers : {body.get('n_workers', 0)} "
        f"({counts.get('healthy', 0)} healthy / "
        f"{counts.get('stale', 0)} stale / "
        f"{counts.get('dead', 0)} dead)"
        f"    [stale>{cfg.get('stale_after', 0):g}s "
        f"dead>{cfg.get('dead_after', 0):g}s]")
    merged = body.get("merged") or {}
    c = merged.get("counters", {})
    r = merged.get("rates", {})
    if c:
        lines.append(
            f"  fleet   : {_fmt_n(c.get('execs', 0))} execs"
            f" | {_fmt_n(r.get('execs', {}).get('rate', 0.0))}/s ema"
            f" | {_fmt_n(c.get('new_paths', 0))} paths"
            f" | {_fmt_n(c.get('crashes', 0))} crashes "
            f"({_fmt_n(c.get('unique_crashes', 0))} uniq)"
            f" | {_fmt_n(c.get('hangs', 0))} hangs")
    if c.get("gossip_rounds") or c.get("sync_quarantined") \
            or c.get("peers_banned"):
        lines.append(
            f"  gossip  : "
            f"{_fmt_n(c.get('gossip_entries_in', 0))} in / "
            f"{_fmt_n(c.get('gossip_entries_out', 0))} out"
            f" | {_fmt_n(c.get('sync_quarantined', 0))} quarantined"
            f" | {_fmt_n(c.get('peers_banned', 0))} peer bans")
    # hybrid campaigns (docs/HYBRID.md): per-tier worker fold + the
    # cross-tier validation rollup — hidden for fleets whose workers
    # are all device-tier ("tpu" in the shared worker-meta format)
    tiers = body.get("tiers") or {}
    if len(tiers) > 1 or (tiers and "tpu" not in tiers):
        parts = []
        for t in sorted(tiers):
            tv = tiers[t]
            tc = tv.get("counters", {})
            parts.append(
                f"{t} {tv.get('n_workers', 0)}w "
                f"({_fmt_n(tc.get('execs', 0))} execs, "
                f"{_fmt_n(tc.get('crashes', 0))} crashes)")
        lines.append("  tiers   : " + " | ".join(parts))
    val = body.get("validation") or {}
    if val.get("validations") or val.get("queue_depth"):
        v = val.get("verdicts", {})
        lines.append(
            f"  hybrid  : {_fmt_n(val.get('validations', 0))} "
            f"validated"
            f" | {_fmt_n(v.get('confirmed', 0))} confirmed / "
            f"{_fmt_n(v.get('proxy_only', 0))} proxy-only / "
            f"{_fmt_n(v.get('flaky', 0))} flaky"
            f" | queue {val.get('queue_depth', 0)} "
            f"(oldest {_fmt_age(val.get('queue_age_s', 0.0))})")
    active = [a for a in body.get("alerts", []) if a.get("active")]
    if active:
        now = body.get("t", time.time())
        for a in active:
            since = a.get("since")
            age = f" for {_fmt_age(now - since)}" if since else ""
            det = a.get("details") or {}
            det_s = (" (" + ", ".join(f"{k}={v}"
                                      for k, v in sorted(det.items()))
                     + ")") if det else ""
            lines.append(f"  ALERT   : {a['alert']} active{age}"
                         f"{det_s}")
    else:
        lines.append("  alerts  : none active")
    workers = body.get("workers", {})
    if workers:
        lines.append("")
        lines.append(
            f"  {'worker':<18} {'status':<8} {'tier':<7} "
            f"{'last seen':>9} "
            f"{'execs':>8} {'execs/s':>9} {'paths':>6} "
            f"{'crashes':>7} {'hangs':>6}")
        for name in sorted(workers):
            w = workers[name]
            s = w.get("stats", {})
            meta = w.get("meta") or {}
            tier = meta.get("tier") or "tpu"
            lines.append(
                f"  {name:<18} {w.get('status', '?'):<8} "
                f"{tier:<7} "
                f"{_fmt_age(w.get('age', 0.0)):>9} "
                f"{_fmt_n(s.get('execs', 0)):>8} "
                f"{_fmt_n(s.get('execs_per_sec_ema', 0.0)):>9} "
                f"{_fmt_n(s.get('new_paths', 0)):>6} "
                f"{_fmt_n(s.get('crashes', 0)):>7} "
                f"{_fmt_n(s.get('hangs', 0)):>6}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-fleet",
        description="fleet observatory console: per-worker health/"
                    "rate table, fleet totals and alert states from "
                    "a manager's /api/fleet endpoints")
    p.add_argument("manager", help="manager base URL "
                                   "(e.g. http://mgr:8650)")
    p.add_argument("--campaign",
                   help="campaign key (job id); omit to list "
                        "campaigns")
    p.add_argument("--json", action="store_true",
                   help="print the raw API response (scripts/CI)")
    p.add_argument("--watch", action="store_true",
                   help="ANSI live-redraw mode (ctrl-c exits)")
    p.add_argument("-i", "--interval", type=float, default=2.0,
                   help="refresh seconds for --watch (default 2)")
    p.add_argument("--plot-data", action="store_true",
                   help="dump the fleet-wide afl-plot-compatible "
                        "CSV from /api/fleet/<campaign>/series and "
                        "exit")
    args = p.parse_args(argv)
    url = args.manager.rstrip("/")

    if args.plot_data:
        if not args.campaign:
            print("error: --plot-data needs --campaign",
                  file=sys.stderr)
            return 2
        try:
            with urllib.request.urlopen(
                    f"{url}/api/fleet/{args.campaign}/series"
                    f"?format=plot", timeout=30) as resp:
                sys.stdout.write(resp.read().decode())
            return 0
        except (OSError, ValueError) as e:
            print(f"error: series fetch failed: {e}",
                  file=sys.stderr)
            return 1

    def frame() -> Optional[str]:
        try:
            if args.campaign:
                body = _get(f"{url}/api/fleet/{args.campaign}")
                # the no-workers gate applies to --json too: the
                # documented contract is a nonzero exit scripts can
                # gate on, and --json is the scripting mode
                if not body.get("n_workers"):
                    print(f"error: no workers seen for campaign "
                          f"{args.campaign!r} at {url}",
                          file=sys.stderr)
                    return None
                if args.json:
                    return json.dumps(body, indent=2)
                return render_fleet(body, url)
            body = _get(f"{url}/api/fleet")
            if args.json:
                return json.dumps(body, indent=2)
            return render_index(body, url)
        except (OSError, ValueError) as e:
            print(f"error: manager at {url} unreachable: {e}",
                  file=sys.stderr)
            return None

    if not args.watch:
        out = frame()
        if out is None:
            return 1
        print(out)
        return 0
    try:
        while True:
            out = frame()
            sys.stdout.write("\x1b[H\x1b[J")
            sys.stdout.write(out if out is not None
                             else "waiting for manager ...")
            sys.stdout.write("\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
