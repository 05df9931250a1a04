"""kb-timeline — flight-recorder analysis (critical path, stage
occupancy, pipeline bubbles).

Loads a campaign's ``trace.json`` (the ``--trace`` span ring, Chrome
trace-event JSON) plus ``events.jsonl`` and ``fuzzer_stats`` when
present, and answers the questions the aggregate stats can't: where
did wall-clock go per stage, how full was the pipeline, WHERE are the
bubbles (device idle while the host mutates/triages), and do the
recorded events reconcile with the counters.  This is the artifact
that shows a dispatch-vs-triage race in one glance instead of a
debugging session.  Run as ``python -m
killerbeez_tpu_torch.tools.timeline_tool`` (``kb-timeline`` below).

    kb-timeline output/                 # human report + ANSI lane view
    kb-timeline output/ --json          # machine report
    kb-timeline output/trace.json --width 100 --bubble-ms 5
    kb-timeline --fleet http://mgr:8650 --campaign 7   # fleet merge

``--fleet`` pulls every worker's forwarded event stream (plus the
manager's health/alert records) from ``/api/events/<campaign>`` and
merges them onto ONE wall-clock axis — the records carry the same
wall timestamps the local overlay anchors on ``wall_t0``, so a
two-worker campaign reads as one timeline: who found what when,
which worker went dead, when the alert fired.

Not to be confused with ``kb-trace`` (the host-tier ptrace edge
harvester, ``tools/tracer.py`` / ``native/``): kb-trace records what a
HOST TARGET executed; kb-timeline analyzes what the device-tier fuzzing
PIPELINE did.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.aggregate import merge_events
from ..telemetry.events import read_events
from ..telemetry.sink import parse_fuzzer_stats
from ..telemetry.trace import load_chrome_trace

#: stages that are HOST attention (bubble attribution candidates);
#: "execute" is the device dispatch, "in_flight" is occupancy
HOST_STAGES = ("mutate", "host_transfer", "triage", "learn",
               "corpus_feedback",
               "fs_write", "crack", "sync_round")

#: the port's own host stages (telemetry/metrics.py STAGES); bubbles
#: found on a CUDA campaign's ``device`` lane may fall in them, while a
#: trace without that lane is read as the JAX package's tool reads it
PORT_STAGES = ("telemetry", "checkpoint")

#: lane-view glyph per span name (top-of-stack wins)
GLYPHS = {"mutate": "m", "execute": "x", "host_transfer": "h",
          "triage": "t", "corpus_feedback": "c", "fs_write": "w",
          "in_flight": ".", "crack": "K", "sync_round": "s"}


# -- span reconstruction ------------------------------------------------


def spans_from_chrome(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Pair B/E events (per tid, stack discipline) and async b/e
    pairs (matched by tid+name+id — the in-flight windows, which
    cross sync span boundaries) back into ``{name, tid, t0, t1}``
    spans (microseconds, trace-relative)."""
    spans: List[Dict[str, Any]] = []
    stacks: Dict[int, List[Dict[str, Any]]] = {}
    open_async: Dict[tuple, Dict[str, Any]] = {}
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        tid = int(ev.get("tid", 0))
        if ph == "B":
            stacks.setdefault(tid, []).append(
                {"name": ev.get("name", "?"), "tid": tid,
                 "t0": float(ev.get("ts", 0.0)), "t1": None,
                 "args": ev.get("args")})
        elif ph == "E":
            stack = stacks.get(tid)
            if stack:
                s = stack.pop()
                s["t1"] = float(ev.get("ts", 0.0))
                spans.append(s)
        elif ph == "b":
            open_async[(tid, ev.get("name"), ev.get("id"))] = {
                "name": ev.get("name", "?"), "tid": tid,
                "t0": float(ev.get("ts", 0.0)), "t1": None,
                "args": ev.get("args")}
        elif ph == "e":
            s = open_async.pop(
                (tid, ev.get("name"), ev.get("id")), None)
            if s is not None:
                s["t1"] = float(ev.get("ts", 0.0))
                spans.append(s)
    spans.sort(key=lambda s: (s["t0"], s["t1"]))
    return spans


def device_spans_from_chrome(doc: Dict[str, Any]
                             ) -> List[Dict[str, Any]]:
    """The ``device`` lane's complete (ph X) events as ``{name, tid,
    t0, t1}`` spans: each ``dispatch`` and each batch's ``kernels``,
    ``triage`` and ``report``, timed on the card and placed on the
    host's clock (telemetry/device.py).  Empty without that lane (a
    CPU campaign)."""
    lanes = {tid for tid, name in lane_names_from_chrome(doc).items()
             if name == "device"}
    spans = [{"name": ev.get("name", "?"), "tid": int(ev.get("tid", 0)),
              "t0": float(ev.get("ts", 0.0)),
              "t1": float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0)),
              "args": None}
             for ev in doc.get("traceEvents", [])
             if ev.get("ph") == "X" and int(ev.get("tid", 0)) in lanes]
    spans.sort(key=lambda s: (s["t0"], s["t1"]))
    return spans


def lane_names_from_chrome(doc: Dict[str, Any]) -> Dict[int, str]:
    names: Dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[int(ev.get("tid", 0))] = \
                (ev.get("args") or {}).get("name", "")
    return names


def instants_from_chrome(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [{"name": ev.get("name", "?"), "tid": int(ev.get("tid", 0)),
             "ts": float(ev.get("ts", 0.0)), "args": ev.get("args")}
            for ev in doc.get("traceEvents", []) if ev.get("ph") == "i"]


# -- interval math ------------------------------------------------------


def _union_len(ivals: List[Tuple[float, float]]) -> float:
    """Total length covered by a set of (t0, t1) intervals."""
    total = 0.0
    end = float("-inf")
    for t0, t1 in sorted(ivals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def stage_report(spans: List[Dict[str, Any]]
                 ) -> Tuple[Dict[str, Dict[str, float]], float]:
    """Per-stage {total_us, count, occupancy} plus the trace window
    length.  ``total_us`` sums span durations (nesting double-counts,
    matching the registry's attention split); ``occupancy`` is the
    fraction of the window with >= 1 span of that stage open."""
    if not spans:
        return {}, 0.0
    w0 = min(s["t0"] for s in spans)
    w1 = max(s["t1"] for s in spans)
    window = max(w1 - w0, 1e-9)
    by: Dict[str, List[Tuple[float, float]]] = {}
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        by.setdefault(s["name"], []).append((s["t0"], s["t1"]))
    def _q(durs, permille):
        # nearest-rank index ceil(q*n)-1 in exact integer math (a
        # floor over n-1 would bias every tail percentile LOW — with
        # 2 spans the p99 would report the MINIMUM duration)
        n = len(durs)
        rank = -(-permille * n // 1000)          # ceil
        return durs[min(n - 1, max(0, rank - 1))]

    for name, ivals in by.items():
        durs = sorted(t1 - t0 for t0, t1 in ivals)
        out[name] = {
            "total_us": sum(durs),
            "count": len(ivals),
            "occupancy": _union_len(ivals) / window,
            # span-duration quantiles (nearest rank) — the per-stage
            # latency shape, matching the registry histograms'
            # p50/p90/p99 keys
            "p50_us": _q(durs, 500),
            "p90_us": _q(durs, 900),
            "p99_us": _q(durs, 990),
        }
    return out, window


def detect_bubbles(spans: List[Dict[str, Any]],
                   threshold_us: Optional[float] = None,
                   device: Optional[List[Dict[str, Any]]] = None
                   ) -> Tuple[List[Dict[str, Any]], float]:
    """Pipeline-bubble detection: a bubble is a gap between
    consecutive device dispatches (``execute`` spans, merged across
    lanes) during which HOST stages were busy — the device sat idle
    while the host mutated/triaged/synced.  Returns (bubbles,
    threshold_used).  The auto threshold is 4x the median
    dispatch-to-dispatch gap (floored at 200us): a steady pipeline's
    natural cadence never alarms, a stall several times that does.

    With ``device`` (the ``device`` lane's spans) the dispatches are
    its ``dispatch`` spans instead: the card's own time, where a host
    ``execute`` span may hold a wait for the card.  A gap is then
    stream time with no dispatch on it, the port's stages may take
    it, and a gap no host stage overlaps is ``untimed``."""
    if device:
        ex = sorted([(s["t0"], s["t1"]) for s in device
                     if s["name"] == "dispatch"])
        stages = HOST_STAGES + PORT_STAGES
    else:
        ex = sorted([(s["t0"], s["t1"]) for s in spans
                     if s["name"] == "execute"])
        stages = HOST_STAGES
    if len(ex) < 3:
        return [], 0.0
    merged: List[Tuple[float, float]] = []
    for t0, t1 in ex:
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    gaps = [(a1, b0) for (a0, a1), (b0, b1)
            in zip(merged, merged[1:]) if b0 > a1]
    if not gaps:
        return [], 0.0
    if threshold_us is None:
        sizes = sorted(b - a for a, b in gaps)
        median = sizes[len(sizes) // 2]
        threshold_us = max(4.0 * median, 200.0)
    host = [s for s in spans if s["name"] in stages]
    bubbles: List[Dict[str, Any]] = []
    for g0, g1 in gaps:
        dur = g1 - g0
        if dur < threshold_us:
            continue
        # attribute to the host stage holding the most of the gap
        overlap: Dict[str, float] = {}
        for s in host:
            o = min(s["t1"], g1) - max(s["t0"], g0)
            if o > 0:
                overlap[s["name"]] = overlap.get(s["name"], 0.0) + o
        if not overlap and not device:
            continue                     # idle-idle: not a host bubble
        dominant = max(overlap.items(), key=lambda kv: kv[1]) \
            if overlap else ("untimed", 0.0)
        bubbles.append({
            "t0_us": g0, "duration_us": dur,
            "dominant_stage": dominant[0],
            "dominant_us": dominant[1],
            "host_overlap_us": sum(overlap.values()),
        })
    return bubbles, threshold_us


def device_report(device: List[Dict[str, Any]]
                  ) -> Optional[Dict[str, Any]]:
    """The ``device`` lane's summary: dispatches, the share of the
    lane's window (first dispatch's start to last one's end) the card
    spent inside dispatches, and each layer's device time."""
    disp = [(s["t0"], s["t1"]) for s in device if s["name"] == "dispatch"]
    if not disp:
        return None
    w0 = min(t0 for t0, _ in disp)
    window = max(max(t1 for _, t1 in disp) - w0, 1e-9)
    layers: Dict[str, float] = {}
    for s in device:
        if s["name"] != "dispatch":
            layers[s["name"]] = layers.get(s["name"], 0.0) \
                + s["t1"] - s["t0"]
    return {"dispatches": len(disp), "window_us": window,
            "busy_share": _union_len(disp) / window,
            "layers_us": layers}


def generations_report(spans: List[Dict[str, Any]],
                       instants: Optional[List[Dict[str, Any]]] = None
                       ) -> Optional[Dict[str, Any]]:
    """--generations campaign analysis: each device dispatch's
    in-flight span carries its generation count in the span args;
    report dispatch/generation totals, DEVICE occupancy over the
    generation window (fraction of the window with a G-generation
    dispatch in flight) and host-stage occupancy over the same
    window.  ``device_bound`` says whether the device, not host
    mutate/triage, holds the critical path.

    Mesh campaigns (--generations on --mesh) additionally stamp one
    ``shard_generations`` instant per dp shard per dispatch; those
    fold into a ``shards`` section — per-shard dispatch/generation
    totals plus each shard's generation occupancy over the window.
    The dispatch is ONE mesh program (shards advance in lockstep, so
    the instants are stamped host-side for every shard together):
    the rows certify that each shard spent the window inside
    G-generation dispatches at mesh scale, they are not a per-shard
    divergence detector — a slow or wedged shard stalls the whole
    program and shows up as mesh-wide occupancy loss or a watchdog
    stall, never as one diverging row."""
    disp = [s for s in spans
            if s.get("name") == "in_flight"
            and (s.get("args") or {}).get("generations")]
    if not disp:
        return None
    w0 = min(s["t0"] for s in disp)
    w1 = max(s["t1"] for s in disp)
    window = max(w1 - w0, 1e-9)
    gens = [int(s["args"]["generations"]) for s in disp]
    dev = _union_len([(s["t0"], s["t1"]) for s in disp]) / window
    host_iv = [(max(s["t0"], w0), min(s["t1"], w1))
               for s in spans if s["name"] in HOST_STAGES
               and s["t1"] > w0 and s["t0"] < w1]
    host = _union_len(host_iv) / window
    report = {
        "dispatches": len(disp),
        "generations_total": sum(gens),
        "generations_min": min(gens),
        "generations_max": max(gens),
        "device_occupancy": dev,
        "host_occupancy": host,
        "window_us": window,
        "device_bound": bool(dev > host),
    }
    shard_marks = [ev for ev in (instants or [])
                   if ev.get("name") == "shard_generations"
                   and (ev.get("args") or {}).get("shard")
                   is not None]
    if shard_marks:
        # dispatch intervals sorted once; a shard's occupancy is the
        # union of the dispatch windows it stamped a mark inside
        ivals = sorted((s["t0"], s["t1"]) for s in disp)
        shards: Dict[str, Dict[str, Any]] = {}
        for ev in shard_marks:
            a = ev["args"]
            d = shards.setdefault(str(int(a["shard"])), {
                "dispatches": 0, "generations_total": 0,
                "_ivals": []})
            d["dispatches"] += 1
            d["generations_total"] += int(a.get("generations", 0))
            ts = float(ev["ts"])
            # the campaign stamps shard instants at dispatch time,
            # just BEFORE the loop opens the dispatch's in_flight
            # window (and while the previous window is still open
            # under the double buffer): attribute the mark to the
            # window whose OPEN is nearest — "first still-open
            # window" would hand every mark to the previous dispatch
            # and drop the final window from every shard's union
            hit = min(ivals, key=lambda iv: abs(iv[0] - ts)) \
                if ivals else None
            if hit is not None:
                d["_ivals"].append(hit)
        for d in shards.values():
            d["occupancy"] = _union_len(d.pop("_ivals")) / window
        report["shards"] = dict(sorted(shards.items(),
                                       key=lambda kv: int(kv[0])))
        report["n_shards"] = len(shards)
    return report


def sessions_report(events: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Stateful session tier: the campaign's ``state_cov`` events
    (one per state x edge coverage high-water increase,
    fuzzer/loop.py) as a growth summary — how many protocol states
    the campaign reached and how the state x edge frontier moved
    over the run.  None for non-stateful campaigns."""
    sc = [e for e in list(events)
          if e.get("type") == "state_cov"]
    if not sc:
        return None
    sc.sort(key=lambda e: float(e.get("t", 0.0)))
    first, last = sc[0], sc[-1]
    return {
        "increases": len(sc),
        "pairs": int(last.get("pairs", 0)),
        "states": int(last.get("states", 0)),
        "first_pairs": int(first.get("pairs", 0)),
        "window_s": float(last.get("t", 0.0))
        - float(first.get("t", 0.0)),
    }


# -- events -------------------------------------------------------------


def event_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    counts: Dict[str, int] = {}
    last: Dict[str, float] = {}
    for e in events:
        t = e.get("type", "?")
        counts[t] = counts.get(t, 0) + 1
        last[t] = max(last.get(t, 0.0), float(e.get("t", 0.0)))
    return {"counts": counts, "last": last, "total": len(events)}


def reconcile(events: List[Dict[str, Any]],
              stats: Dict[str, str]) -> Dict[str, Any]:
    """Check the event-log contract against fuzzer_stats: one
    new_path event per paths_total, one crash per unique_crashes, one
    hang per unique_hangs."""
    counts: Dict[str, int] = {}
    for e in events:
        t = e.get("type", "?")
        counts[t] = counts.get(t, 0) + 1
    out: Dict[str, Any] = {}
    for etype, key in (("new_path", "paths_total"),
                       ("crash", "unique_crashes"),
                       ("hang", "unique_hangs")):
        want = int(stats.get(key, 0))
        got = counts.get(etype, 0)
        out[etype] = {"events": got, key: want, "ok": got == want}
    out["ok"] = all(v["ok"] for v in out.values()
                    if isinstance(v, dict))
    return out


# -- fleet mode ---------------------------------------------------------

#: glyph per event type in the fleet lane view (one row per worker)
FLEET_GLYPHS = {"new_path": ".", "crash": "C", "hang": "H",
                "plateau": "P", "crack_injection": "K",
                "sync_round": "s", "scheduler_pick": "r",
                "flush": "f", "worker_stale": "S",
                "worker_dead": "D", "worker_returned": "R",
                "alert": "A"}


def fetch_fleet_events(manager_url: str, campaign: str
                       ) -> List[Dict[str, Any]]:
    """Drain ``/api/events/<campaign>`` through its cursor and return
    ONE merged, deduped, total-ordered stream with each record tagged
    by its origin worker (``merge_events`` — the same fold the
    heartbeat aggregates use)."""
    events: List[Dict[str, Any]] = []
    since = 0
    while True:
        url = (f"{manager_url}/api/events/{campaign}"
               f"?since={since}")
        with urllib.request.urlopen(url, timeout=30) as resp:
            body = json.loads(resp.read())
        rows = body.get("events") or []
        if not rows:
            break
        for r in rows:
            rec = r.get("event")
            if not isinstance(rec, dict):
                continue
            rec = dict(rec)
            rec.setdefault("worker", r.get("worker", "?"))
            events.append(rec)
        latest = int(body.get("latest", since))
        if latest <= since:
            break
        since = latest
    return merge_events(events)


def fleet_report(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-worker and per-type summary over the merged wall-clock
    stream."""
    counts: Dict[str, int] = {}
    by_worker: Dict[str, Dict[str, int]] = {}
    ts = [float(e.get("t", 0.0)) for e in events]
    for e in events:
        t = e.get("type", "?")
        counts[t] = counts.get(t, 0) + 1
        w = str(e.get("worker", "?"))
        by_worker.setdefault(w, {})
        by_worker[w][t] = by_worker[w].get(t, 0) + 1
    active_alerts = {}
    for e in events:                     # stream order = final state
        if e.get("type") == "alert" and e.get("alert"):
            active_alerts[e["alert"]] = bool(e.get("active"))
    return {
        "total": len(events),
        "t0": min(ts) if ts else 0.0,
        "t1": max(ts) if ts else 0.0,
        "window_s": (max(ts) - min(ts)) if ts else 0.0,
        "counts": counts,
        "workers": by_worker,
        "active_alerts": sorted(a for a, on in active_alerts.items()
                                if on),
    }


def render_fleet(report: Dict[str, Any],
                 events: List[Dict[str, Any]],
                 width: int = 72) -> str:
    """One wall-clock axis, one lane per worker (the manager's
    health/alert records ride the ``_manager`` lane)."""
    lines: List[str] = []
    head = "kb-timeline — fleet event timeline (merged wall clock)"
    lines.append(head)
    lines.append("=" * len(head))
    lines.append(
        f"  window  : {report['window_s']:.1f}s  "
        f"({report['total']} events, "
        f"{len(report['workers'])} streams)")
    pairs = ", ".join(f"{k} x{v}" for k, v in
                      sorted(report["counts"].items()))
    lines.append(f"  events  : {pairs}")
    if report["active_alerts"]:
        lines.append("  alerts  : "
                     + ", ".join(report["active_alerts"])
                     + " ACTIVE")
    t0, window = report["t0"], max(report["window_s"], 1e-9)
    scale = (width - 1) / window
    label_w = max([len(w) for w in report["workers"]] + [6])
    glyphs = "  ".join(f"{g}={n}" for n, g in FLEET_GLYPHS.items())
    lines.append(f"  lanes ({glyphs}):")
    for w in sorted(report["workers"]):
        cells = [" "] * width
        for e in events:
            if str(e.get("worker", "?")) != w:
                continue
            i = int((float(e.get("t", 0.0)) - t0) * scale)
            if 0 <= i < width:
                cells[i] = FLEET_GLYPHS.get(e.get("type"), "#")
        lines.append(f"  {w:<{label_w}} |{''.join(cells)}|")
    lines.append(f"  {'':<{label_w}} |0{' ' * (width - 2)}|  "
                 f"({report['window_s']:.1f}s window)")
    return "\n".join(lines)


# -- rendering ----------------------------------------------------------


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}us"


def lane_view(spans: List[Dict[str, Any]],
              instants: List[Dict[str, Any]],
              lane_names: Dict[int, str], window: float,
              width: int = 72) -> List[str]:
    """One text row per lane, a glyph per time bucket (top-of-stack
    span wins; later spans overwrite earlier in the same bucket), and
    an events row overlaying instant markers."""
    if not spans or window <= 0:
        return []
    t0 = min(s["t0"] for s in spans)
    scale = width / window
    rows: List[str] = []
    tids = sorted({s["tid"] for s in spans})
    label_w = max([len(lane_names.get(t, f"lane-{t}")) for t in tids]
                  + [6])
    for tid in tids:
        cells = [" "] * width
        for s in sorted((s for s in spans if s["tid"] == tid),
                        key=lambda s: (s["t1"] - s["t0"]),
                        reverse=True):
            a = int((s["t0"] - t0) * scale)
            b = int((s["t1"] - t0) * scale)
            g = GLYPHS.get(s["name"], "#")
            for i in range(max(a, 0), min(b + 1, width)):
                cells[i] = g
        name = lane_names.get(tid, f"lane-{tid}")
        rows.append(f"  {name:<{label_w}} |{''.join(cells)}|")
    if instants:
        cells = [" "] * width
        for ev in instants:
            i = int((ev["ts"] - t0) * scale)
            if 0 <= i < width:
                cells[i] = "!"
        rows.append(f"  {'events':<{label_w}} |{''.join(cells)}|")
    rows.append(f"  {'':<{label_w}} "
                f"|0{' ' * (width - 2)}|  ({_fmt_us(window)} window)")
    return rows


def render(report: Dict[str, Any], lanes: List[str]) -> str:
    lines: List[str] = []
    head = "kb-timeline — flight-recorder analysis"
    lines.append(head)
    lines.append("=" * len(head))
    window = report.get("window_us", 0.0)
    lines.append(f"  trace window : {_fmt_us(window)}  "
                 f"({report.get('span_count', 0)} spans, "
                 f"{report.get('lane_count', 0)} lanes)")
    stages = report.get("stages", {})
    if stages:
        lines.append("  per-stage wall clock (host attention):")
        acc = sum(v["total_us"] for k, v in stages.items()
                  if k != "in_flight") or 1.0
        for name, v in sorted(stages.items(),
                              key=lambda kv: -kv[1]["total_us"]):
            if name == "in_flight":
                continue
            frac = v["total_us"] / acc
            row = (
                f"    {name:<15} {_fmt_us(v['total_us']):>10}  "
                f"{frac:6.1%}  ({int(v['count'])} spans, "
                f"{v['occupancy']:.1%} occupancy)")
            if "p50_us" in v:
                row += (f"  p50 {_fmt_us(v['p50_us'])}"
                        f" p99 {_fmt_us(v['p99_us'])}")
            lines.append(row)
        cp = report.get("critical_path")
        if cp:
            lines.append(f"  critical path : {cp} "
                         f"(highest occupancy outside the device)")
        inf = stages.get("in_flight")
        if inf:
            lines.append(
                f"  pipeline      : {inf['occupancy']:.1%} of the "
                f"window with batches in flight "
                f"({int(inf['count'])} batches)")
    gr = report.get("generations")
    if gr:
        lines.append(
            f"  generations   : {gr['dispatches']} device dispatches"
            f" x {gr['generations_min']}"
            + (f"-{gr['generations_max']}"
               if gr["generations_max"] != gr["generations_min"]
               else "")
            + f" generations ({gr['generations_total']} total)")
        lines.append(
            f"                  device {gr['device_occupancy']:.1%} "
            f"vs host {gr['host_occupancy']:.1%} occupancy over the "
            f"generation window — "
            + ("DEVICE-bound (host stages off the critical path)"
               if gr["device_bound"] else "host-bound"))
        for sid, sd in (gr.get("shards") or {}).items():
            lines.append(
                f"    shard-{sid:<4} {sd['dispatches']} dispatches, "
                f"{sd['generations_total']} generations, "
                f"{sd['occupancy']:.1%} occupancy")
    sr = report.get("sessions")
    if sr:
        lines.append(
            f"  sessions      : {sr['states']} protocol states "
            f"reached, {sr['pairs']} state x edge pairs covered "
            f"({sr['increases']} coverage increases over "
            f"{sr['window_s']:.1f}s)")
    bubbles = report.get("bubbles", [])
    lines.append(
        f"  bubbles       : {len(bubbles)} detected, "
        f"{_fmt_us(report.get('bubble_total_us', 0.0))} total "
        f"(threshold {_fmt_us(report.get('bubble_threshold_us', 0.0))})")
    dv = report.get("device")
    if dv:
        layers = ", ".join(f"{k} {_fmt_us(v)}" for k, v in
                           sorted(dv["layers_us"].items(),
                                  key=lambda kv: -kv[1]))
        lines.append(
            f"  device lane   : {dv['dispatches']} dispatches, busy "
            f"{dv['busy_share']:.2%} of {_fmt_us(dv['window_us'])} "
            f"({layers}); bubbles are its gaps")
    for b in bubbles[:8]:
        lines.append(
            f"    @{_fmt_us(b['t0_us'])}: device idle "
            f"{_fmt_us(b['duration_us'])} while host ran "
            f"{b['dominant_stage']} ({_fmt_us(b['dominant_us'])})")
    if len(bubbles) > 8:
        lines.append(f"    ... {len(bubbles) - 8} more")
    ev = report.get("events")
    if ev:
        pairs = ", ".join(f"{k} x{v}" for k, v in
                          sorted(ev["counts"].items()))
        lines.append(f"  events        : {pairs}")
    rec = report.get("reconcile")
    if rec:
        ok = "OK" if rec.get("ok") else "MISMATCH"
        lines.append(
            f"  reconcile     : {ok} (new_path "
            f"{rec['new_path']['events']}/"
            f"{rec['new_path']['paths_total']}, crash "
            f"{rec['crash']['events']}/"
            f"{rec['crash']['unique_crashes']}, hang "
            f"{rec['hang']['events']}/"
            f"{rec['hang']['unique_hangs']} vs fuzzer_stats)")
    if lanes:
        glyphs = "  ".join(f"{g}={n}" for n, g in GLYPHS.items())
        lines.append("  lane view (" + glyphs + "):")
        lines.extend(lanes)
    return "\n".join(lines)


# -- entry --------------------------------------------------------------


def analyze(out_dir: str, trace_path: Optional[str] = None,
            bubble_us: Optional[float] = None
            ) -> Tuple[Optional[Dict[str, Any]], List[Dict], Dict]:
    """Returns (chrome doc or None, events list, fuzzer_stats dict)."""
    if trace_path is None:
        trace_path = os.path.join(out_dir, "trace.json")
    doc = load_chrome_trace(trace_path)
    events = list(read_events(os.path.join(out_dir, "events.jsonl")))
    stats: Dict[str, str] = {}
    try:
        stats = parse_fuzzer_stats(os.path.join(out_dir,
                                                "fuzzer_stats"))
    except OSError:
        pass
    return doc, events, stats


def build_report(doc: Optional[Dict[str, Any]],
                 events: List[Dict[str, Any]],
                 stats: Dict[str, str],
                 bubble_us: Optional[float] = None) -> Dict[str, Any]:
    report: Dict[str, Any] = {}
    if doc is not None:
        spans = spans_from_chrome(doc)
        stages, window = stage_report(spans)
        device = device_spans_from_chrome(doc)
        bubbles, thresh = detect_bubbles(spans, bubble_us, device)
        host = {k: v for k, v in stages.items()
                if k not in ("execute", "in_flight")}
        report.update({
            "window_us": window,
            "span_count": len(spans),
            "lane_count": len({s["tid"] for s in spans}),
            "stages": stages,
            "critical_path": (max(host.items(),
                                  key=lambda kv: kv[1]["occupancy"])[0]
                              if host else None),
            "bubbles": bubbles,
            "bubble_total_us": sum(b["duration_us"] for b in bubbles),
            "bubble_threshold_us": thresh,
            "trace_meta": doc.get("otherData", {}),
        })
        gr = generations_report(spans, instants_from_chrome(doc))
        if gr:
            report["generations"] = gr
        dv = device_report(device)
        if dv:
            report["device"] = dv
    if events:
        report["events"] = event_summary(events)
        sr = sessions_report(events)
        if sr:
            report["sessions"] = sr
    if events and stats:
        report["reconcile"] = reconcile(events, stats)
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="kb-timeline",
        description="flight-recorder analysis: per-stage wall clock, "
                    "pipeline occupancy, bubble detection and event "
                    "overlay from a --trace campaign's trace.json + "
                    "events.jsonl")
    p.add_argument("path", nargs="?", default="output",
                   help="campaign output dir, or a trace.json path "
                        "(default ./output)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (scripts/CI)")
    p.add_argument("--width", type=int, default=72,
                   help="lane-view width in columns (default 72)")
    p.add_argument("--bubble-ms", type=float, default=None,
                   help="explicit bubble threshold in ms (default: "
                        "4x the median dispatch gap)")
    p.add_argument("--no-lanes", action="store_true",
                   help="skip the ANSI lane view")
    p.add_argument("--heat", action="store_true",
                   help="append the corpus store's per-byte "
                        "mutation-heat panels (FMViz-style, from "
                        "<path>/corpus provenance sidecars)")
    p.add_argument("--base", metavar="FILE",
                   help="--heat: the campaign's base seed file, so "
                        "first-generation lineage renders too")
    p.add_argument("--fleet", metavar="MANAGER_URL",
                   help="merge the fleet's event streams from a "
                        "manager (/api/events/<campaign>) onto one "
                        "wall-clock axis instead of reading a local "
                        "output dir; needs --campaign")
    p.add_argument("--campaign",
                   help="campaign key for --fleet (job id)")
    args = p.parse_args(argv)

    if args.fleet:
        if not args.campaign:
            print("error: --fleet needs --campaign", file=sys.stderr)
            return 2
        try:
            events = fetch_fleet_events(args.fleet, args.campaign)
        except (OSError, ValueError) as e:
            print(f"error: fleet event fetch from {args.fleet} "
                  f"failed: {e}", file=sys.stderr)
            return 1
        if not events:
            print(f"error: no events for campaign "
                  f"{args.campaign!r} at {args.fleet}",
                  file=sys.stderr)
            return 1
        report = fleet_report(events)
        if args.json:
            print(json.dumps({"report": report, "events": events},
                             indent=2))
        else:
            print(render_fleet(report, events, width=args.width))
        return 0

    path = args.path
    if os.path.isfile(path):
        out_dir, trace_path = os.path.dirname(path) or ".", path
    else:
        out_dir, trace_path = path, None
    doc, events, stats = analyze(out_dir, trace_path)
    if doc is None and not events:
        print("error: no trace.json or events.jsonl under "
              f"{args.path} (run the fuzzer with --trace)",
              file=sys.stderr)
        return 1
    bubble_us = (args.bubble_ms * 1e3 if args.bubble_ms is not None
                 else None)
    report = build_report(doc, events, stats, bubble_us)
    heat_text = None
    if args.heat:
        # lineage heat next to the time axis: which parent bytes the
        # campaign profited from mutating (tools/heat.py)
        from ..corpus.store import CorpusStore
        from .heat import heat_report, render_store_heat
        store_dir = os.path.join(out_dir, "corpus")
        if not os.path.isdir(store_dir):
            print(f"error: --heat needs a corpus store at "
                  f"{store_dir} (run with --corpus-dir)",
                  file=sys.stderr)
            return 1
        heat_entries = CorpusStore(store_dir).load()
        base = None
        if args.base:
            with open(args.base, "rb") as f:
                base = f.read()
        if args.json:
            report["heat"] = heat_report(heat_entries, base=base)
        else:
            heat_text = render_store_heat(heat_entries, base=base)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    lanes: List[str] = []
    if doc is not None and not args.no_lanes:
        # the device lane, where there is one, gets its own row
        spans = spans_from_chrome(doc) + device_spans_from_chrome(doc)
        lanes = lane_view(spans, instants_from_chrome(doc),
                          lane_names_from_chrome(doc),
                          report.get("window_us", 0.0),
                          width=args.width)
    print(render(report, lanes))
    if heat_text is not None:
        print("\nmutation heat (corpus lineage):")
        print(heat_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
