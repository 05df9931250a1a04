"""Fleet observatory — worker health registry, alert rules and the
fleet time-series sampler.

The flight recorder makes one worker legible; this module makes
the FLEET legible (ROADMAP item 4 needs it before any gossip/
multi-pod work can be accepted): the manager classifies every
heartbeating worker healthy/stale/dead against configurable
timeouts, emits schema-versioned ``worker_stale`` / ``worker_dead``
/ ``worker_returned`` records into the SAME campaign event stream
the workers forward into (so kb-timeline, cursor GETs and the
heartbeat dedup machinery apply unchanged), persists periodic fleet
snapshots so history survives worker churn, and evaluates a small
declarative alert-rule set whose firings land in the stream and on
``/metrics`` as ``kbz_alert_active`` gauges.

The evaluator is deliberately declarative: each rule is a pure
function ``(view, cfg) -> (active, details)`` over a per-campaign
view the monitor maintains (merged counters, per-worker statuses,
find/exec recency, a trailing unique-crash window).  Thresholds all
live in ``FleetConfig`` (manager CLI flags).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..hybrid.reconcile import fold_tiers, tier_of, validation_summary
from ..telemetry import merge
from ..telemetry.aggregate import STATUS_RANK as _STATUS_RANK
from ..telemetry.openmetrics import (
    add_counter, add_gauge, add_snapshot, new_families,
    render_families,
)
from ..utils.logging import WARNING_MSG

HEALTHY, STALE, DEAD = "healthy", "stale", "dead"


@dataclass
class FleetConfig:
    """Manager-side observatory thresholds (CLI flags in
    ``python -m killerbeez_tpu_torch.manager``)."""

    #: seconds without a heartbeat before a worker reads stale/dead
    stale_after: float = 15.0
    dead_after: float = 60.0
    #: health/alert evaluation cadence (<= 0 disables the thread;
    #: ``tick()`` can still be driven manually — tests do)
    monitor_interval: float = 2.0
    #: seconds between persisted fleet_series samples per campaign
    series_interval: float = 10.0
    #: newest samples kept per campaign (oldest pruned at insert —
    #: the history table must not grow unboundedly, same discipline
    #: as --events-max-mb; 0 = unbounded)
    series_max_rows: int = 20000
    #: fleet_plateau: no fleet-wide new path for this many seconds
    plateau_after: float = 300.0
    #: coverage_stall: execs still advancing but paths flat this long
    stall_after: float = 900.0
    #: crash_spike: >= this many new unique crashes inside the window
    crash_spike_count: int = 10
    crash_spike_window: float = 60.0
    #: findings_drop: the fleet's findings_ring_drops counter moved
    #: within this many seconds — --generations findings rings are
    #: overflowing and finding files/events under-report (raise
    #: gen_findings_cap); clears once drops stop for a full window
    drops_window: float = 120.0
    #: seconds after a worker's last heartbeat before its registry
    #: row (and heartbeat snapshot) is retired entirely — finished
    #: campaigns stop latching worker_death forever and /metrics
    #: label cardinality stays bounded (0 = never retire)
    retire_after: float = 86400.0
    #: validation_backlog: the hybrid bridge's oldest queued finding
    #: has waited this long — the native tier is falling behind the
    #: TPU tier and verdicts are going stale (docs/HYBRID.md)
    validation_backlog_after: float = 120.0


def classify(age: float, cfg: FleetConfig) -> str:
    """Heartbeat age -> health status."""
    if age >= cfg.dead_after:
        return DEAD
    if age >= cfg.stale_after:
        return STALE
    return HEALTHY


# -- alert rules --------------------------------------------------------
#
# A rule sees the campaign view:
#   {"now", "statuses": {worker: status}, "counters": merged counters,
#    "gauges": merged gauges, "paths_changed_t", "execs_changed_t",
#    "drops_changed_t", "crash_window": deque of (t, unique_crashes),
#    "started": bool}


def _rule_worker_death(view: Dict[str, Any], cfg: FleetConfig
                       ) -> Tuple[bool, Dict[str, Any]]:
    dead = sorted(w for w, s in view["statuses"].items() if s == DEAD)
    return bool(dead), {"dead_workers": dead}


def _rule_fleet_plateau(view: Dict[str, Any], cfg: FleetConfig
                        ) -> Tuple[bool, Dict[str, Any]]:
    if not view["started"]:
        return False, {}
    quiet = view["now"] - view["paths_changed_t"]
    return quiet >= cfg.plateau_after, {
        "seconds_without_new_path": round(quiet, 1)}


def _rule_crash_spike(view: Dict[str, Any], cfg: FleetConfig
                      ) -> Tuple[bool, Dict[str, Any]]:
    win = view["crash_window"]
    if not win:
        return False, {}
    delta = win[-1][1] - win[0][1]
    return delta >= cfg.crash_spike_count, {
        "unique_crashes_in_window": int(delta),
        "window_s": cfg.crash_spike_window}


def _rule_coverage_stall(view: Dict[str, Any], cfg: FleetConfig
                         ) -> Tuple[bool, Dict[str, Any]]:
    """Paths flat for ``stall_after`` while execs still advance —
    the fleet is burning cycles without learning anything (distinct
    from a plateau, which fires sooner and regardless of execs)."""
    if not view["started"]:
        return False, {}
    now = view["now"]
    stalled = now - view["paths_changed_t"] >= cfg.stall_after
    fuzzing = now - view["execs_changed_t"] < cfg.stall_after
    return stalled and fuzzing, {
        "seconds_without_new_path":
            round(now - view["paths_changed_t"], 1)}


def _rule_findings_drop(view: Dict[str, Any], cfg: FleetConfig
                        ) -> Tuple[bool, Dict[str, Any]]:
    """``findings_ring_drops`` advanced within the window: some
    worker's --generations findings ring is overflowing, so finding
    files and events UNDER-REPORT what the campaign is discovering
    (the counter is the only honest record).  Fires on recency, not
    on the lifetime total — a long-finished overflow must not alarm
    forever — and clears after ``drops_window`` quiet seconds."""
    drops = int(view["counters"].get("findings_ring_drops", 0))
    if drops <= 0:
        return False, {}
    recent = view["now"] - view["drops_changed_t"] < cfg.drops_window
    return recent, {"findings_ring_drops_total": drops,
                    "seconds_since_last_drop":
                        round(view["now"] - view["drops_changed_t"],
                              1)}


def _rule_validation_backlog(view: Dict[str, Any], cfg: FleetConfig
                             ) -> Tuple[bool, Dict[str, Any]]:
    """The hybrid bridge's validation queue has findings older than
    ``validation_backlog_after``: the native tier cannot keep up and
    cross-tier verdicts lag the frontier they should steer.  Only
    fires for campaigns that post the queue gauges at all — a pure
    TPU or pure native fleet never alarms."""
    g = view.get("gauges", {})
    depth = int(g.get("validation_queue_depth", 0))
    age = float(g.get("validation_queue_age", 0.0))
    active = depth > 0 and age >= cfg.validation_backlog_after
    return active, {"queue_depth": depth,
                    "oldest_age_s": round(age, 1)}


#: declarative rule table: name -> predicate
ALERT_RULES: Tuple[Tuple[str, Callable], ...] = (
    ("worker_death", _rule_worker_death),
    ("fleet_plateau", _rule_fleet_plateau),
    ("crash_spike", _rule_crash_spike),
    ("coverage_stall", _rule_coverage_stall),
    ("findings_drop", _rule_findings_drop),
    ("validation_backlog", _rule_validation_backlog),
)


class FleetMonitor(threading.Thread):
    """Periodic fleet evaluator: health transitions, alert rules and
    the fleet_series sampler, one ``tick()`` per interval.

    Manager-origin events go through ``ManagerDB.add_manager_event``
    (worker ``_manager``, its own monotone seq per campaign), so they
    ride the exact cursor/dedup path worker-forwarded events use.
    """

    def __init__(self, db, cfg: Optional[FleetConfig] = None,
                 time_fn=time.time):
        super().__init__(daemon=True)
        self.db = db
        self.cfg = cfg or FleetConfig()
        self._time = time_fn
        self._halt = threading.Event()
        #: campaign -> mutable evaluator state (touched only by
        #: tick(), which _lock serializes)
        self._state: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        #: campaign -> alert snapshot list, REPLACED (never mutated)
        #: at the end of each campaign pass so /api/fleet and
        #: /metrics read it lock-free — a scrape never stalls behind
        #: a tick's DB I/O
        self._alert_view: Dict[str, List[Dict[str, Any]]] = {}

    # -- lifecycle ------------------------------------------------------

    def run(self) -> None:
        while not self._halt.wait(self.cfg.monitor_interval):
            try:
                self.tick()
            except Exception as e:       # observability never crashes
                WARNING_MSG("fleet monitor tick failed: %s", e)

    def stop(self) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=self.cfg.monitor_interval + 1)

    # -- evaluation -----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """One evaluation pass (tests drive this directly with a
        synthetic clock).  The lock only serializes concurrent
        ticks; readers go through the lock-free ``_alert_view``."""
        now = self._time() if now is None else now
        with self._lock:
            if self.cfg.retire_after > 0:
                self.db.retire_fleet_workers(
                    now - self.cfg.retire_after)
            rows = self.db.get_fleet_workers()   # one scan per tick
            by_campaign: Dict[str, List[Dict[str, Any]]] = {}
            for row in rows:
                by_campaign.setdefault(row["campaign"],
                                       []).append(row)
            self._tick_health(rows, now)
            campaigns = self.db.fleet_campaigns()
            for campaign in campaigns:
                self._tick_campaign(
                    campaign, now, by_campaign.get(campaign, []))
            # a retired campaign's evaluator state (and published
            # alert snapshot) goes with it — otherwise a stale
            # worker_death view outlives the workers it described
            known = set(campaigns)
            for gone in [c for c in self._alert_view
                         if c not in known]:
                self._alert_view.pop(gone, None)
                self._state.pop(gone, None)

    def _tick_health(self, rows, now: float) -> None:
        """Escalate stored worker statuses against heartbeat age and
        emit transition events.  De-escalation (``worker_returned``)
        happens at heartbeat ingest (api.h_stats) — absent
        heartbeats, classification only worsens over time.  The
        status write is conditioned on ``last_seen`` being unchanged,
        so a heartbeat racing the tick wins and no spurious
        stale/dead record lands in the append-only stream."""
        for row in rows:
            want = classify(now - row["last_seen"], self.cfg)
            have = row.get("status", HEALTHY)
            if _STATUS_RANK.get(want, 0) <= _STATUS_RANK.get(have, 0):
                continue
            if not self.db.set_fleet_worker_status(
                    row["campaign"], row["worker"], want,
                    expect_last_seen=row["last_seen"]):
                continue                 # a fresh beat won the race
            self.db.add_manager_event(
                row["campaign"], f"worker_{want}",
                worker=row["worker"],
                last_seen=row["last_seen"],
                age=round(now - row["last_seen"], 3))

    def _campaign_state(self, campaign: str, now: float
                        ) -> Dict[str, Any]:
        st = self._state.get(campaign)
        if st is None:
            st = self._state[campaign] = {
                "paths": -1, "paths_changed_t": now,
                "execs": -1, "execs_changed_t": now,
                # drops recency starts "long quiet": a restart must
                # not re-fire findings_drop on a stale lifetime total
                "drops": -1, "drops_changed_t": float("-inf"),
                "crash_window": deque(),
                "last_series_t": 0.0,
                "alerts": {name: {"active": False, "since": None,
                                  "details": {}}
                           for name, _ in ALERT_RULES},
            }
        return st

    def _tick_campaign(self, campaign: str, now: float,
                       workers: List[Dict[str, Any]]) -> None:
        cfg = self.cfg
        st = self._campaign_state(campaign, now)
        statuses = {w["worker"]: classify(now - w["last_seen"], cfg)
                    for w in workers}
        stats = self.db.get_campaign_stats(campaign)
        merged = merge([r["snapshot"] for r in stats]) or {}
        counters = merged.get("counters", {})

        # recency trackers for the plateau/stall rules
        paths = int(counters.get("new_paths", 0))
        if paths != st["paths"]:
            if st["paths"] >= 0 or paths > 0:
                st["paths_changed_t"] = now
            st["paths"] = paths
        execs = int(counters.get("execs", 0))
        if execs != st["execs"]:
            st["execs_changed_t"] = now
            st["execs"] = execs
        drops = int(counters.get("findings_ring_drops", 0))
        if drops != st["drops"]:
            # the FIRST observation only baselines (a manager restart
            # must not re-alarm on a lifetime total whose drops may
            # have stopped hours ago), and only an INCREASE counts as
            # movement — the merged total of a monotone counter can
            # shrink when a worker restarts or retires, which is not
            # a new drop
            if st["drops"] >= 0 and drops > st["drops"]:
                st["drops_changed_t"] = now
            st["drops"] = drops
        win = st["crash_window"]
        win.append((now, int(counters.get("unique_crashes", 0))))
        while win and win[0][0] < now - cfg.crash_spike_window:
            win.popleft()

        view = {"now": now, "statuses": statuses,
                "counters": counters,
                "gauges": merged.get("gauges", {}),
                "paths": st["paths"],
                "paths_changed_t": st["paths_changed_t"],
                "execs_changed_t": st["execs_changed_t"],
                "drops_changed_t": st["drops_changed_t"],
                "crash_window": win, "started": execs > 0}
        for name, rule in ALERT_RULES:
            active, details = rule(view, cfg)
            slot = st["alerts"][name]
            if active and not slot["active"]:
                slot.update(active=True, since=now, details=details)
                self.db.add_manager_event(
                    campaign, "alert", alert=name, active=True,
                    **details)
            elif not active and slot["active"]:
                slot.update(active=False, details=details)
                self.db.add_manager_event(
                    campaign, "alert", alert=name, active=False)
            elif active:
                slot["details"] = details
        # publish this pass's alert snapshot (atomic dict store —
        # readers never see a half-updated view and never block)
        self._alert_view[campaign] = [
            {"alert": name, **dict(st["alerts"][name])}
            for name, _ in ALERT_RULES]

        # fleet time-series: survives worker churn, feeds fleet-wide
        # plot_data and the kb-fleet history view
        if workers and now - st["last_series_t"] >= cfg.series_interval:
            st["last_series_t"] = now
            counts = {s: 0 for s in (HEALTHY, STALE, DEAD)}
            for s in statuses.values():
                counts[s] += 1
            gauges = merged.get("gauges", {})
            rates = merged.get("rates", {})
            self.db.add_fleet_sample(campaign, {
                "t": now,
                "n_workers": len(workers),
                "workers_healthy": counts[HEALTHY],
                "workers_stale": counts[STALE],
                "workers_dead": counts[DEAD],
                "execs": execs,
                "new_paths": paths,
                "crashes": int(counters.get("crashes", 0)),
                "unique_crashes":
                    int(counters.get("unique_crashes", 0)),
                "hangs": int(counters.get("hangs", 0)),
                "unique_hangs": int(counters.get("unique_hangs", 0)),
                "corpus_seen": int(gauges.get(
                    "corpus_seen", gauges.get("corpus_size", 0))),
                "execs_per_sec_ema":
                    float(rates.get("execs", {}).get("rate", 0.0)),
            }, max_rows=cfg.series_max_rows)

    # -- views ----------------------------------------------------------

    def alerts(self, campaign: str) -> List[Dict[str, Any]]:
        """Current alert states for a campaign (all configured rules,
        with an ``active`` flag — /metrics wants the zeros too).
        Lock-free: reads the snapshot the last tick published, so a
        Prometheus scrape never stalls behind a tick's DB I/O."""
        view = self._alert_view.get(campaign)
        if view is not None:
            return view
        return [{"alert": name, "active": False, "since": None,
                 "details": {}} for name, _ in ALERT_RULES]


# -- views shared by /api/fleet and kb-fleet ---------------------------


def worker_stats_summary(snap: Dict[str, Any]) -> Dict[str, Any]:
    """The compact per-worker numbers kb-fleet tabulates."""
    c = snap.get("counters", {})
    g = snap.get("gauges", {})
    d = snap.get("derived", {})
    return {
        "execs": int(c.get("execs", 0)),
        "new_paths": int(c.get("new_paths", 0)),
        "crashes": int(c.get("crashes", 0)),
        "unique_crashes": int(c.get("unique_crashes", 0)),
        "hangs": int(c.get("hangs", 0)),
        "unique_hangs": int(c.get("unique_hangs", 0)),
        "corpus_seen": int(g.get("corpus_seen",
                                 g.get("corpus_size", 0))),
        "findings_ring_drops": int(c.get("findings_ring_drops", 0)),
        # partition-tolerance row: quarantined synced-in entries,
        # gossip flow and the worker's current/lifetime peer bans —
        # the fleet-chaos CI lane asserts on these via kb-fleet --json
        "sync_quarantined": int(c.get("sync_quarantined", 0)),
        "gossip_entries_in": int(c.get("gossip_entries_in", 0)),
        "gossip_entries_out": int(c.get("gossip_entries_out", 0)),
        "peers_banned": int(c.get("peers_banned", 0)),
        "peers_banned_active": int(g.get("peers_banned_active", 0)),
        # hybrid bridge row: cross-tier verdict counters + the
        # validation queue the backlog alert watches (docs/HYBRID.md)
        "hybrid_validations": int(c.get("hybrid_validations", 0)),
        "hybrid_confirmed": int(c.get("hybrid_confirmed", 0)),
        "hybrid_proxy_only": int(c.get("hybrid_proxy_only", 0)),
        "hybrid_flaky": int(c.get("hybrid_flaky", 0)),
        "validation_queue_depth":
            int(g.get("validation_queue_depth", 0)),
        "execs_per_sec": float(d.get("execs_per_sec", 0.0)),
        "execs_per_sec_ema": float(d.get("execs_per_sec_ema", 0.0)),
    }


def peer_directory(db, cfg: FleetConfig, campaign: str,
                   exclude: Optional[str] = None,
                   now: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
    """``/api/peers/<campaign>``: every NON-DEAD worker that has
    registered a gossip endpoint.  Liveness rides the same health
    registry as /api/fleet — the directory and the observatory can
    never disagree about who is alive.  EXCEPT while the manager is
    write-degraded: heartbeat writes are failing, so last_seen is
    frozen fleet-wide and the liveness classification is stale — the
    directory then serves every registered endpoint rather than
    falsely reading the whole fleet dead."""
    now = time.time() if now is None else now
    frozen = bool(getattr(db, "degraded", False))
    out: List[Dict[str, Any]] = []
    for row in db.get_fleet_workers(campaign):
        meta = row.get("meta")
        endpoint = meta.get("gossip") if isinstance(meta, dict) \
            else None
        if not endpoint or row["worker"] == exclude:
            continue
        status = classify(max(0.0, now - row["last_seen"]), cfg)
        if status == DEAD and not frozen:
            continue
        out.append({"worker": row["worker"], "endpoint": endpoint,
                    "status": status,
                    "last_seen": row["last_seen"]})
    return out


def fleet_view(db, cfg: FleetConfig, campaign: str,
               monitor: Optional[FleetMonitor] = None,
               now: Optional[float] = None) -> Dict[str, Any]:
    """The ``/api/fleet/<campaign>`` response body: live-classified
    worker health (age against the config, not the stored status —
    accurate between monitor ticks), per-worker stat summaries, the
    merged fleet snapshot (with a ``health`` section that folds via
    ``aggregate.merge_health``), and current alert states."""
    now = time.time() if now is None else now
    rows = db.get_fleet_workers(campaign)
    stats = {r["worker"]: r for r in db.get_campaign_stats(campaign)}
    workers: Dict[str, Any] = {}
    counts = {s: 0 for s in (HEALTHY, STALE, DEAD)}
    health: Dict[str, Any] = {}
    for row in rows:
        age = max(0.0, now - row["last_seen"])
        status = classify(age, cfg)
        counts[status] += 1
        entry = {
            "first_seen": row["first_seen"],
            "last_seen": row["last_seen"],
            "age": round(age, 3),
            "status": status,
            "beats": row.get("beats", 0),
            "meta": row.get("meta"),
        }
        srow = stats.get(row["worker"])
        if srow is not None:
            entry["stats"] = worker_stats_summary(srow["snapshot"])
        workers[row["worker"]] = entry
        health[row["worker"]] = {"status": status,
                                 "first_seen": row["first_seen"],
                                 "last_seen": row["last_seen"]}
    merged = merge([r["snapshot"] for r in stats.values()])
    if merged is not None and health:
        merged["health"] = health
    # per-tier fold (hybrid campaigns; docs/HYBRID.md): workers group
    # by meta["tier"] — a pure TPU fleet shows one "tpu" tier and the
    # validation rollup reads all-zero
    statuses = {w: e["status"] for w, e in workers.items()}
    tiers = fold_tiers(rows, stats, statuses)
    return {
        "campaign": campaign,
        "t": now,
        "config": {"stale_after": cfg.stale_after,
                   "dead_after": cfg.dead_after},
        "n_workers": len(rows),
        "counts": counts,
        "workers": workers,
        "merged": merged,
        "tiers": tiers,
        "validation": validation_summary(merged),
        "alerts": (monitor.alerts(campaign) if monitor is not None
                   else []),
    }


def _workers_by_campaign(db) -> Dict[str, List[Dict[str, Any]]]:
    """One all-campaigns scan grouped in python — the endpoints must
    not issue a fleet_workers query per campaign (N+1 under the DB
    lock on every scrape)."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for row in db.get_fleet_workers():
        out.setdefault(row["campaign"], []).append(row)
    return out


def fleet_index(db, cfg: FleetConfig,
                now: Optional[float] = None) -> Dict[str, Any]:
    """``/api/fleet``: one summary row per known campaign."""
    now = time.time() if now is None else now
    by_campaign = _workers_by_campaign(db)
    out: Dict[str, Any] = {}
    for campaign in db.fleet_campaigns():
        rows = by_campaign.get(campaign, [])
        counts = {s: 0 for s in (HEALTHY, STALE, DEAD)}
        for row in rows:
            counts[classify(max(0.0, now - row["last_seen"]),
                            cfg)] += 1
        out[campaign] = {"n_workers": len(rows), **counts}
    return {"t": now, "campaigns": out,
            "degraded": bool(getattr(db, "degraded", False))}


def render_fleet_metrics(db, cfg: FleetConfig,
                         monitor: Optional[FleetMonitor] = None,
                         now: Optional[float] = None) -> str:
    """The manager's ``/metrics`` exposition: every campaign's
    per-worker registry snapshots labeled ``{campaign, worker}``,
    fleet folds under the ``kbz_fleet_`` namespace labeled
    ``{campaign}`` (so a Prometheus ``sum()`` over workers never
    double-counts the fold), worker liveness gauges, and
    ``kbz_alert_active`` per alert rule."""
    now = time.time() if now is None else now
    fams = new_families()
    add_gauge(fams, "kbz_manager_degraded",
              1.0 if getattr(db, "degraded", False) else 0.0,
              help_text="1 = DB writes failing; manager serving "
                        "read-only off the admission journal")
    by_campaign = _workers_by_campaign(db)
    for campaign in db.fleet_campaigns():
        labels_c = {"campaign": campaign}
        stats = db.get_campaign_stats(campaign)
        for row in stats:
            add_snapshot(fams, row["snapshot"],
                         {"campaign": campaign,
                          "worker": row["worker"]})
        merged = merge([r["snapshot"] for r in stats])
        if merged is not None:
            add_snapshot(fams, merged, labels_c,
                         prefix="kbz_fleet", include_hists=False)
        counts = {s: 0 for s in (HEALTHY, STALE, DEAD)}
        for row in by_campaign.get(campaign, []):
            status = classify(max(0.0, now - row["last_seen"]), cfg)
            counts[status] += 1
            wl = {"campaign": campaign, "worker": row["worker"]}
            add_gauge(fams, "kbz_worker_up",
                      1.0 if status == HEALTHY else 0.0, wl,
                      help_text="1 = heartbeat within stale_after")
            add_gauge(fams,
                      "kbz_worker_last_seen_timestamp_seconds",
                      row["last_seen"], wl)
            add_counter(fams, "kbz_worker_heartbeats",
                        row.get("beats", 0), wl)
        for status, n in counts.items():
            add_gauge(fams, "kbz_fleet_workers", n,
                      {"campaign": campaign, "status": status},
                      help_text="workers by health status")
        # hybrid campaign series (docs/HYBRID.md): per-tier worker
        # counts and the cross-tier verdict counters — only emitted
        # once a campaign actually posts tier tags / hybrid counters,
        # so pure TPU fleets keep their exact historical scrape
        tier_counts: Dict[str, int] = {}
        for row in by_campaign.get(campaign, []):
            t = tier_of(row.get("meta"))
            tier_counts[t] = tier_counts.get(t, 0) + 1
        if len(tier_counts) > 1 or (tier_counts and
                                    "tpu" not in tier_counts):
            for t, n in sorted(tier_counts.items()):
                add_gauge(fams, "kbz_fleet_tier_workers", n,
                          {"campaign": campaign, "tier": t},
                          help_text="workers by execution tier")
        mc = (merged or {}).get("counters", {})
        if "hybrid_validations" in mc:
            for verdict in ("confirmed", "proxy_only", "flaky"):
                add_counter(fams, "kbz_hybrid_validations",
                            mc.get(f"hybrid_{verdict}", 0),
                            {"campaign": campaign,
                             "verdict": verdict},
                            help_text="cross-tier validation "
                                      "verdicts (hybrid bridge)")
            mg = (merged or {}).get("gauges", {})
            add_gauge(fams, "kbz_validation_queue_depth",
                      mg.get("validation_queue_depth", 0), labels_c,
                      help_text="findings awaiting native "
                                "validation")
        if monitor is not None:
            for a in monitor.alerts(campaign):
                add_gauge(fams, "kbz_alert_active",
                          1.0 if a["active"] else 0.0,
                          {"campaign": campaign,
                           "alert": a["alert"]},
                          help_text="declarative alert rule state")
    return render_families(fams)
