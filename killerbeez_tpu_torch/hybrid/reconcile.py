"""Per-tier coverage reconciliation (hybrid campaigns).

Everything fleet-visible carries a ``tier`` tag: corpus sidecars
(store schema), worker heartbeats (``meta["tier"]``) and gossip rows
(the sidecar meta rides the exchange untouched).  This module folds
those tags into the per-tier summaries ``kb-fleet --json`` serves —
worker counts, health, exec/find counters per tier — plus the
fleet-wide validation rollup (queue depth/age, verdict counters).

The native tier appears in the fleet through
:class:`NativeHeartbeat`: a sidecar thread posting the bridge's
counters to the manager with ``meta={"tier": "native"}``, so a
hybrid campaign's single process shows up as one device worker AND one
native worker — the same shape a physically split fleet has.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

#: tier assumed for anything minted before the hybrid bridge existed
#: (untagged heartbeats, pre-hybrid sidecars)
DEFAULT_TIER = "tpu"


def tier_of(meta: Optional[Dict[str, Any]]) -> str:
    """The tier a heartbeat / sidecar / gossip row belongs to."""
    if isinstance(meta, dict):
        t = meta.get("tier")
        if isinstance(t, str) and t:
            return t
    return DEFAULT_TIER


#: counters worth showing per tier in kb-fleet (subset of a worker
#: snapshot — the full merge stays fleet-wide)
_TIER_COUNTERS = ("execs", "new_paths", "crashes", "unique_crashes",
                  "hybrid_validations")


def fold_tiers(rows: List[Dict[str, Any]],
               stats: Dict[str, Dict[str, Any]],
               statuses: Dict[str, str]) -> Dict[str, Dict[str, Any]]:
    """Group fleet workers by tier and fold per-tier summaries.

    ``rows`` are the fleet DB worker rows (name + meta), ``stats``
    maps worker -> last posted stats body, ``statuses`` maps worker
    -> health class (healthy/stale/dead/retired).  Pure — the
    manager and tests call it with whatever view they hold."""
    from ..telemetry.aggregate import merge

    tiers: Dict[str, Dict[str, Any]] = {}
    by_tier: Dict[str, List[str]] = {}
    for row in rows:
        name = row.get("worker") or row.get("name")
        if not name:
            continue
        by_tier.setdefault(tier_of(row.get("meta")), []).append(name)
    for tier, names in sorted(by_tier.items()):
        snaps = [stats[n].get("snapshot") or stats[n]
                 for n in names if n in stats]
        merged = merge([s for s in snaps
                        if isinstance(s, dict)]) or {}
        counters = merged.get("counters", {})
        gauges = merged.get("gauges", {})
        counts: Dict[str, int] = {}
        for n in names:
            st = statuses.get(n, "unknown")
            counts[st] = counts.get(st, 0) + 1
        tiers[tier] = {
            "n_workers": len(names),
            "counts": counts,
            "counters": {k: counters[k] for k in _TIER_COUNTERS
                         if k in counters},
            "execs_per_sec_ema":
                merged.get("rates", {}).get("execs_per_sec_ema",
                                            gauges.get(
                                                "execs_per_sec_ema")),
        }
    return tiers


def validation_summary(merged: Dict[str, Any]) -> Dict[str, Any]:
    """The fleet-wide cross-tier validation rollup from a merged
    stats snapshot (kb-fleet --json ``validation`` section)."""
    counters = merged.get("counters", {}) if merged else {}
    gauges = merged.get("gauges", {}) if merged else {}
    return {
        "validations": int(counters.get("hybrid_validations", 0)),
        "verdicts": {
            "confirmed": int(counters.get("hybrid_confirmed", 0)),
            "proxy_only": int(counters.get("hybrid_proxy_only", 0)),
            "flaky": int(counters.get("hybrid_flaky", 0)),
        },
        "proxy_gaps": int(counters.get("hybrid_proxy_gaps", 0)),
        "queue_depth": int(gauges.get("validation_queue_depth", 0)),
        "queue_age_s": float(gauges.get("validation_queue_age", 0.0)),
    }


class NativeHeartbeat(threading.Thread):
    """Posts the hybrid bridge's native-tier stats to the manager.

    One per hybrid campaign process; the TPU loop's own Heartbeat
    keeps posting as before (tier "tpu"), this thread adds the
    ``<worker>-native`` row so per-tier views see both tiers even
    when they share a host process."""

    def __init__(self, bridge, manager_url: str, campaign: str,
                 worker: str, interval: float = 5.0):
        super().__init__(daemon=True, name="hybrid-native-heartbeat")
        self.bridge = bridge
        self.manager_url = manager_url.rstrip("/")
        self.campaign = campaign
        self.worker = worker if worker.endswith("-native") \
            else f"{worker}-native"
        self.interval = float(interval)
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def post_once(self) -> bool:
        from ..manager.worker import _request
        try:
            _request(
                f"{self.manager_url}/api/stats/{self.campaign}",
                {"worker": self.worker,
                 "snapshot": self.bridge.snapshot(),
                 "meta": {"tier": "native", "pid": os.getpid()}})
            return True
        except Exception:
            return False                 # next beat retries

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            self.post_once()
        self.post_once()                 # parting beat
