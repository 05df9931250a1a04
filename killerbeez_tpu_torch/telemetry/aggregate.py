"""Snapshot merging — fold N registry snapshots into one campaign
view.

A copy of the JAX package's ``telemetry/aggregate.py``.  The (dp, mp)
mesh campaign folds per-shard stat dicts each sync epoch with it
(parallel/campaign.py), and the manager folds worker heartbeats into
the ``/api/stats/<campaign>`` response with it.  The merge is
associative and commutative, so fold order — shard order, heartbeat
arrival order, tree vs linear reduction — can never change the answer:

  * counters    — summed (totals add across workers)
  * gauges      — max (a fleet's corpus size / pipeline depth is the
                  worst-case view; summing would double-count shared
                  state)
  * EMA rates   — weight-weighted mean, weights summed: a worker
                  that has observed half a horizon contributes half
                  strength.  (rate*weight, weight) pairs add, which
                  is what makes the mean associative.
  * histograms  — bucket-wise counts summed (p50/p90/p99 re-derived
                  from the merged counts — quantiles never average)
  * health      — per-worker liveness dicts union; on conflict the
                  record with the newest ``last_seen`` wins (tie:
                  worse status), ``first_seen`` min / ``last_seen``
                  max — a total order, so the fold stays associative
  * start_time  — min; ``t`` — max (the merged view spans the fleet)
  * event logs  — exact-duplicate-deduped union, sorted into one
                  fleet timeline (``merge_events``; snapshots carrying
                  an ``events`` list fold through it automatically)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .metrics import percentiles_from_counts


def _merge_rates(a: Dict[str, Dict[str, float]],
                 b: Dict[str, Dict[str, float]]
                 ) -> Dict[str, Dict[str, float]]:
    out = dict(a)
    for k, rb in b.items():
        ra = out.get(k)
        if ra is None:
            out[k] = dict(rb)
            continue
        w = ra.get("weight", 0.0) + rb.get("weight", 0.0)
        if w <= 0:
            out[k] = {"rate": 0.0, "weight": 0.0}
        else:
            out[k] = {
                "rate": (ra.get("rate", 0.0) * ra.get("weight", 0.0)
                         + rb.get("rate", 0.0) * rb.get("weight", 0.0)
                         ) / w,
                "weight": w,
            }
    return out


def _merge_hists(a: Dict[str, Dict], b: Dict[str, Dict]
                 ) -> Dict[str, Dict]:
    out = {k: dict(v) for k, v in a.items()}
    for k, hb in b.items():
        ha = out.get(k)
        if ha is None:
            out[k] = dict(hb)
            continue
        ca, cb = list(ha.get("counts", [])), list(hb.get("counts", []))
        if len(ca) < len(cb):
            ca += [0] * (len(cb) - len(ca))
        for i, v in enumerate(cb):
            ca[i] += v
        out[k] = {"counts": ca,
                  "total": ha.get("total", 0) + hb.get("total", 0),
                  "sum": ha.get("sum", 0.0) + hb.get("sum", 0.0)}
        # quantiles are re-derived from the merged counts — merging
        # per-worker p50s would be wrong AND order-dependent
        out[k].update(percentiles_from_counts(ca))
    return out


#: health-status severity (worse = higher) — the ONE ordering behind
#: both the merge tie-break here and the manager monitor's
#: escalation checks
STATUS_RANK = {"healthy": 0, "stale": 1, "dead": 2}
_STATUS_RANK = STATUS_RANK


def merge_health(a: Optional[Dict[str, Dict]],
                 b: Optional[Dict[str, Dict]]) -> Dict[str, Dict]:
    """Fold per-worker health dicts (``{worker: {status, first_seen,
    last_seen, ...}}``).  Per worker: the record with the greater
    ``(last_seen, status severity)`` supplies the fields (a TOTAL
    order — associative + commutative), then ``first_seen`` takes the
    min and ``last_seen`` the max across both."""
    def _key(h: Dict) -> tuple:
        return (h.get("last_seen", 0.0),
                _STATUS_RANK.get(h.get("status"), 0))

    out = {w: dict(h) for w, h in (a or {}).items()}
    for w, hb in (b or {}).items():
        ha = out.get(w)
        if ha is None:
            out[w] = dict(hb)
            continue
        win = dict(hb) if _key(hb) >= _key(ha) else dict(ha)
        fs = [h.get("first_seen") for h in (ha, hb)
              if h.get("first_seen") is not None]
        ls = [h.get("last_seen") for h in (ha, hb)
              if h.get("last_seen") is not None]
        if fs:
            win["first_seen"] = min(fs)
        if ls:
            win["last_seen"] = max(ls)
        out[w] = win
    return out


def merge_events(a: List[Dict], b: Optional[List[Dict]] = None
                 ) -> List[Dict]:
    """Fold event-log record lists into one fleet timeline.

    Exact duplicates (a record forwarded through two paths, or the
    same heartbeat replayed) collapse to one; the result is sorted by
    ``(t, worker, seq, canonical json)`` — a TOTAL order, which is
    what makes the fold associative and commutative regardless of
    which worker's log arrives first."""
    seen: Dict[str, Dict] = {}
    for rec in list(a) + list(b or []):
        seen.setdefault(json.dumps(rec, sort_keys=True), rec)
    return sorted(
        seen.values(),
        key=lambda r: (r.get("t", 0), str(r.get("worker", "")),
                       r.get("seq", 0),
                       json.dumps(r, sort_keys=True)))


def merge_two(a: Dict[str, object], b: Dict[str, object]
              ) -> Dict[str, object]:
    ca, cb = a.get("counters", {}), b.get("counters", {})
    counters = dict(ca)
    for k, v in cb.items():
        counters[k] = counters.get(k, 0) + v
    ga, gb = a.get("gauges", {}), b.get("gauges", {})
    gauges = dict(ga)
    for k, v in gb.items():
        gauges[k] = max(gauges.get(k, float("-inf")), v)
    out: Dict[str, object] = {
        "counters": counters,
        "gauges": gauges,
        "rates": _merge_rates(a.get("rates", {}), b.get("rates", {})),
        "hists": _merge_hists(a.get("hists", {}), b.get("hists", {})),
    }
    ev_a, ev_b = a.get("events"), b.get("events")
    if ev_a or ev_b:
        out["events"] = merge_events(ev_a or [], ev_b or [])
    h_a, h_b = a.get("health"), b.get("health")
    if h_a or h_b:
        out["health"] = merge_health(h_a, h_b)
    st = [s.get("start_time") for s in (a, b)
          if s.get("start_time") is not None]
    ts = [s.get("t") for s in (a, b) if s.get("t") is not None]
    if st:
        out["start_time"] = min(st)
    if ts:
        out["t"] = max(ts)
    if st and ts:
        out["elapsed"] = out["t"] - out["start_time"]
    # derived values are recomputed, never merged: a mean of ratios
    # is not the ratio of the sums
    rates = out["rates"]
    execs_rate = rates.get("execs", {})
    elapsed = out.get("elapsed") or 0
    out["derived"] = {
        "execs_per_sec": (counters.get("execs", 0) / elapsed
                          if elapsed and elapsed > 0 else 0.0),
        "execs_per_sec_ema": execs_rate.get("rate", 0.0),
    }
    return out


def merge(snapshots: List[Dict[str, object]]
          ) -> Optional[Dict[str, object]]:
    """Fold any number of snapshots; [] -> None, [s] -> normalized s."""
    if not snapshots:
        return None
    acc: Dict[str, object] = {"counters": {}, "gauges": {},
                              "rates": {}, "hists": {}}
    for s in snapshots:
        acc = merge_two(acc, s)
    return acc
