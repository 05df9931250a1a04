"""The port's fleet observatory (killerbeez_tpu_torch/manager/fleet.py,
telemetry/openmetrics, kb-fleet, kb-timeline --fleet), the counterpart
of tests/test_fleet.py on the CPU: the fleet observatory tests
(manager/fleet.py, telemetry/openmetrics,
kb-fleet, kb-timeline --fleet) — the two-worker e2e the CI fleet lane
runs: register -> heartbeat -> one worker dies -> ``worker_dead``
event + worker_death alert within the configured timeout ->
``/api/fleet`` and ``/metrics`` reflect it (with the ``/metrics``
body checked by the strict OpenMetrics parser), plus deterministic
alert-rule / time-series / cursor coverage driven through manual
monitor ticks with a synthetic clock.
"""

import json
import threading
import time
import urllib.request

import pytest

from killerbeez_tpu_torch.manager import ManagerDB
from killerbeez_tpu_torch.manager.api import ManagerServer
from killerbeez_tpu_torch.manager.fleet import (
    ALERT_RULES, FleetConfig, FleetMonitor, classify,
    render_fleet_metrics,
)
from killerbeez_tpu_torch.telemetry import MetricsRegistry
from killerbeez_tpu_torch.telemetry.openmetrics import (
    render_snapshot, sanitize_metric_name,
)
from openmetrics_parser import parse_openmetrics, sample_value

FAST = dict(stale_after=0.3, dead_after=0.6, monitor_interval=0.05,
            series_interval=0.1, plateau_after=30.0, stall_after=60.0,
            crash_spike_count=3, crash_spike_window=5.0)


@pytest.fixture
def server():
    s = ManagerServer(port=0, fleet=FleetConfig(**FAST))
    s.start()
    yield s
    s.stop()


def _get(server, path, raw=False):
    url = f"http://127.0.0.1:{server.port}{path}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        body = resp.read()
        return body.decode() if raw else json.loads(body)


def _post(server, path, payload):
    url = f"http://127.0.0.1:{server.port}{path}"
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def _snap(execs, paths=0, uc=0, crashes=None, t=None, drops=0):
    return {"t": time.time() if t is None else t, "start_time": 0.0,
            "elapsed": 10.0,
            "counters": {"execs": execs, "new_paths": paths,
                         "crashes": (uc if crashes is None
                                     else crashes),
                         "unique_crashes": uc,
                         "findings_ring_drops": drops},
            "gauges": {"corpus_seen": paths},
            "rates": {"execs": {"rate": 100.0, "weight": 1.0}},
            "derived": {"execs_per_sec": 10.0,
                        "execs_per_sec_ema": 100.0}}


# -- OpenMetrics rendering ---------------------------------------------


def test_openmetrics_roundtrip_through_strict_parser():
    """Every registry series kind survives render -> strict parse
    with its value intact (the satellite round-trip gate)."""
    reg = MetricsRegistry()
    reg.count("execs", 4096)
    reg.count("9weird.name", 3)          # needs sanitization
    reg.gauge("corpus_seen", 17)
    reg.rate("execs", 100)
    for v in (1e-5, 3e-3, 0.4, 2.0):
        reg.observe("triage", v)
    text = render_snapshot(reg.snapshot(), labels={"worker": "w1"})
    fams = parse_openmetrics(text)
    lab = {"worker": "w1"}
    assert fams["kbz_execs"]["type"] == "counter"
    assert sample_value(fams, "kbz_execs", "kbz_execs_total",
                        lab) == 4096
    assert sample_value(fams, "kbz_corpus_seen", "kbz_corpus_seen",
                        lab) == 17
    assert fams["kbz_execs_rate"]["type"] == "gauge"
    hist = fams["kbz_triage_duration_seconds"]
    assert hist["type"] == "histogram"
    counts = [v for n, la, v in hist["samples"]
              if n.endswith("_count")]
    assert counts == [4]
    total = [v for n, la, v in hist["samples"] if n.endswith("_sum")]
    assert total[0] == pytest.approx(1e-5 + 3e-3 + 0.4 + 2.0)


def test_openmetrics_label_escaping_and_sanitization():
    nasty = 'w"1\n\\end'
    text = render_snapshot({"counters": {"execs": 1}},
                           labels={"bad label": nasty})
    fams = parse_openmetrics(text)
    assert sample_value(fams, "kbz_execs", "kbz_execs_total",
                        {"bad_label": nasty}) == 1
    assert sanitize_metric_name("9a-b.c") == "_9a_b_c"


def test_openmetrics_parser_is_actually_strict():
    """The conformance oracle rejects malformed expositions — a
    broken renderer can't pass by accident."""
    good = render_snapshot({"counters": {"execs": 1}})
    parse_openmetrics(good)              # sanity
    for bad in (
        good.replace("# EOF\n", ""),             # missing EOF
        good.replace("kbz_execs_total", "kbz_execs"),  # bad suffix
        "kbz_x 1\n# EOF\n",                      # sample before TYPE
        "# TYPE h histogram\nh_bucket{le=\"1.0\"} 1\n"
        "h_count 1\nh_sum 1\n# EOF\n",           # no +Inf bucket
        "# TYPE h histogram\nh_bucket{le=\"1.0\"} 5\n"
        "h_bucket{le=\"+Inf\"} 3\nh_count 3\nh_sum 1\n"
        "# EOF\n",                               # decreasing buckets
        "# TYPE c counter\nc_total 1\nc_total 2\n# EOF\n",  # dup
    ):
        with pytest.raises(ValueError):
            parse_openmetrics(bad)


# -- health classification ---------------------------------------------


def test_classify_thresholds():
    cfg = FleetConfig(stale_after=10, dead_after=30)
    assert classify(0.0, cfg) == "healthy"
    assert classify(9.9, cfg) == "healthy"
    assert classify(10.0, cfg) == "stale"
    assert classify(29.9, cfg) == "stale"
    assert classify(30.0, cfg) == "dead"


# -- two-worker e2e (the CI fleet lane's acceptance gate) --------------


def test_two_worker_e2e_death_alert_and_metrics(server):
    """Register two workers, kill one: within the configured timeout
    the manager classifies it dead, emits worker_stale/worker_dead
    into the campaign stream, raises the worker_death alert, and
    both /api/fleet and a conformant /metrics scrape reflect it;
    reviving the worker emits worker_returned and clears the
    alert."""
    _post(server, "/api/stats/7",
          {"worker": "w1", "snapshot": _snap(1000, 5),
           "meta": {"pid": 111, "host": "a"}})
    _post(server, "/api/stats/7",
          {"worker": "w2", "snapshot": _snap(500, 3),
           "meta": {"pid": 222, "host": "b"}})

    halt = threading.Event()

    def keep_w1_alive():
        while not halt.wait(0.1):
            _post(server, "/api/stats/7",
                  {"worker": "w1", "snapshot": _snap(1000, 5)})

    t = threading.Thread(target=keep_w1_alive, daemon=True)
    t.start()
    try:
        # poll until the FULL expected state holds — a loaded runner
        # can momentarily delay w1's keep-alive past the 0.3s stale
        # threshold, so breaking on w2's death alone would flake
        deadline = time.time() + 10     # >> dead_after (0.6s)
        fv = None
        while time.time() < deadline:
            fv = _get(server, "/api/fleet/7")
            if (fv["workers"]["w2"]["status"] == "dead"
                    and fv["workers"]["w1"]["status"] == "healthy"
                    and any(a["alert"] == "worker_death"
                            and a["active"] for a in fv["alerts"])):
                break
            time.sleep(0.05)
        assert fv["workers"]["w2"]["status"] == "dead"
        assert fv["workers"]["w1"]["status"] == "healthy"
        assert fv["counts"] == {"healthy": 1, "stale": 0, "dead": 1}
        assert fv["workers"]["w2"]["meta"] == {"pid": 222,
                                              "host": "b"}
        death = [a for a in fv["alerts"]
                 if a["alert"] == "worker_death"][0]
        assert death["active"] is True
        assert death["details"]["dead_workers"] == ["w2"]
        # merged fleet snapshot carries the health fields
        assert fv["merged"]["health"]["w2"]["status"] == "dead"
        assert fv["merged"]["counters"]["execs"] == 1500

        # the event stream has the manager-origin records, cursor-
        # readable exactly like worker events
        ev = _get(server, "/api/events/7")
        types = [(e["worker"], e["event"]["type"])
                 for e in ev["events"]]
        assert ("_manager", "worker_dead") in types
        assert ("_manager", "worker_stale") in types
        alert_evs = [e["event"] for e in ev["events"]
                     if e["event"]["type"] == "alert"]
        assert any(e["alert"] == "worker_death" and e["active"]
                   for e in alert_evs)

        # /metrics: strict-parse the scrape, check the gauges
        text = _get(server, "/metrics", raw=True)
        fams = parse_openmetrics(text)
        assert sample_value(fams, "kbz_worker_up", "kbz_worker_up",
                            {"campaign": "7", "worker": "w2"}) == 0
        assert sample_value(fams, "kbz_worker_up", "kbz_worker_up",
                            {"campaign": "7", "worker": "w1"}) == 1
        assert sample_value(fams, "kbz_alert_active",
                            "kbz_alert_active",
                            {"campaign": "7",
                             "alert": "worker_death"}) == 1
        assert sample_value(fams, "kbz_fleet_workers",
                            "kbz_fleet_workers",
                            {"campaign": "7", "status": "dead"}) == 1
        # fleet fold labeled {campaign} only, per-worker labeled both
        assert sample_value(fams, "kbz_fleet_execs",
                            "kbz_fleet_execs_total",
                            {"campaign": "7"}) == 1500
        assert sample_value(fams, "kbz_execs", "kbz_execs_total",
                            {"campaign": "7", "worker": "w2"}) == 500

        # kb-fleet sees one healthy + one dead worker
        from killerbeez_tpu_torch.tools import fleet_tool
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = fleet_tool.main(
                [f"http://127.0.0.1:{server.port}",
                 "--campaign", "7", "--json"])
        assert rc == 0
        body = json.loads(buf.getvalue())
        statuses = {w: v["status"]
                    for w, v in body["workers"].items()}
        assert statuses == {"w1": "healthy", "w2": "dead"}
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = fleet_tool.main(
                [f"http://127.0.0.1:{server.port}",
                 "--campaign", "7"])
        assert rc == 0
        table = buf.getvalue()
        assert "worker_death active" in table
        assert "dead" in table and "healthy" in table

        # revive w2: worker_returned lands, the alert clears
        _post(server, "/api/stats/7",
              {"worker": "w2", "snapshot": _snap(600, 3)})
        deadline = time.time() + 10
        cleared = False
        while time.time() < deadline:
            fv = _get(server, "/api/fleet/7")
            death = [a for a in fv["alerts"]
                     if a["alert"] == "worker_death"][0]
            if not death["active"] \
                    and fv["workers"]["w2"]["status"] == "healthy":
                cleared = True
                break
            time.sleep(0.05)
        assert cleared
        ev = _get(server, "/api/events/7")
        assert ("_manager", "worker_returned") in [
            (e["worker"], e["event"]["type"]) for e in ev["events"]]
    finally:
        halt.set()
        t.join(timeout=2)


def test_kb_timeline_fleet_merges_worker_streams(server, capsys):
    """--fleet merges two workers' forwarded streams plus the
    manager's records onto one wall-clock axis."""
    t0 = time.time()
    _post(server, "/api/events/7", {"worker": "w1", "events": [
        {"v": 1, "seq": 0, "t": t0, "type": "crash", "md5": "aa"},
        {"v": 1, "seq": 1, "t": t0 + 2.0, "type": "plateau"}]})
    _post(server, "/api/events/7", {"worker": "w2", "events": [
        {"v": 1, "seq": 0, "t": t0 + 1.0, "type": "hang",
         "md5": "bb"}]})
    server.db.add_manager_event("7", "worker_dead", worker="w2",
                                now=t0 + 3.0)
    from killerbeez_tpu_torch.tools import timeline_tool
    rc = timeline_tool.main(
        ["--fleet", f"http://127.0.0.1:{server.port}",
         "--campaign", "7", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    rep = out["report"]
    assert rep["total"] == 4
    assert rep["counts"] == {"crash": 1, "plateau": 1, "hang": 1,
                             "worker_dead": 1}
    # the worker_dead record names its subject worker, so the death
    # marker lands on w2's own lane
    assert set(rep["workers"]) == {"w1", "w2"}
    assert rep["workers"]["w2"]["worker_dead"] == 1
    assert rep["window_s"] == pytest.approx(3.0, abs=0.01)
    # events are total-ordered on the shared wall clock
    ts = [e["t"] for e in out["events"]]
    assert ts == sorted(ts)
    # human rendering: one lane per stream
    rc = timeline_tool.main(
        ["--fleet", f"http://127.0.0.1:{server.port}",
         "--campaign", "7"])
    assert rc == 0
    txt = capsys.readouterr().out
    assert "w1" in txt and "w2" in txt
    # unknown campaign -> loud nonzero
    rc = timeline_tool.main(
        ["--fleet", f"http://127.0.0.1:{server.port}",
         "--campaign", "nope"])
    assert rc == 1


# -- deterministic monitor coverage (manual ticks, synthetic clock) ----


def _mk_monitor(**over):
    cfg = FleetConfig(**{**FAST, **over, "monitor_interval": 0.0})
    db = ManagerDB()
    return db, FleetMonitor(db, cfg)


def test_fleet_series_cursor_pagination():
    db, mon = _mk_monitor(series_interval=1.0)
    now = 1000.0
    db.note_fleet_worker("c", "w1", now=now)
    for i in range(5):
        db.upsert_campaign_stats("c", "w1",
                                 _snap(100 * (i + 1), i, t=now))
        mon.tick(now=now)
        now += 1.0
    rows = db.get_fleet_series("c")
    assert len(rows) == 5
    ids = [r["id"] for r in rows]
    assert ids == sorted(ids)
    assert [r["execs"] for r in rows] == [100, 200, 300, 400, 500]
    # cursor: only samples past the given id come back
    tail = db.get_fleet_series("c", since_id=ids[2])
    assert [r["id"] for r in tail] == ids[3:]
    assert db.fleet_series_latest_id("c") == ids[-1]
    # limit caps the page
    page = db.get_fleet_series("c", since_id=0, limit=2)
    assert [r["id"] for r in page] == ids[:2]
    # history survives worker churn: the dead worker's last totals
    # stay in the series
    sample = rows[-1]
    assert sample["n_workers"] == 1
    assert sample["new_paths"] == 4


def test_alert_rules_plateau_spike_stall():
    db, mon = _mk_monitor(plateau_after=10.0, stall_after=20.0,
                          crash_spike_count=3,
                          crash_spike_window=5.0,
                          series_interval=1e9)
    now = 1000.0
    db.note_fleet_worker("c", "w1", now=now)

    def beat(execs, paths, uc, t):
        db.note_fleet_worker("c", "w1", now=t)
        db.upsert_campaign_stats("c", "w1",
                                 _snap(execs, paths, uc=uc, t=t))

    beat(100, 1, 0, now)
    mon.tick(now=now)
    assert not any(a["active"] for a in mon.alerts("c"))
    # paths flat while execs advance: plateau at +10s, stall at +20s
    for dt in (5.0, 9.0):
        beat(100 + int(dt * 10), 1, 0, now + dt)
        mon.tick(now=now + dt)
    assert not [a for a in mon.alerts("c")
                if a["alert"] == "fleet_plateau" and a["active"]]
    beat(300, 1, 0, now + 11.0)
    mon.tick(now=now + 11.0)
    active = {a["alert"] for a in mon.alerts("c") if a["active"]}
    assert "fleet_plateau" in active
    assert "coverage_stall" not in active
    beat(400, 1, 0, now + 21.0)
    mon.tick(now=now + 21.0)
    active = {a["alert"] for a in mon.alerts("c") if a["active"]}
    assert {"fleet_plateau", "coverage_stall"} <= active
    # a new path clears both
    beat(500, 2, 0, now + 22.0)
    mon.tick(now=now + 22.0)
    active = {a["alert"] for a in mon.alerts("c") if a["active"]}
    assert "fleet_plateau" not in active
    assert "coverage_stall" not in active
    # crash spike: 3 unique crashes inside the 5s window
    beat(600, 3, 1, now + 23.0)
    mon.tick(now=now + 23.0)
    beat(700, 4, 4, now + 24.0)
    mon.tick(now=now + 24.0)
    spike = [a for a in mon.alerts("c")
             if a["alert"] == "crash_spike"][0]
    assert spike["active"]
    # rising edge emitted exactly one active=True alert event
    evs = [json.loads(r["payload"])
           for r in db._rows("SELECT payload FROM campaign_events "
                             "WHERE campaign='c'")]
    spikes = [e for e in evs if e["type"] == "alert"
              and e.get("alert") == "crash_spike"
              and e.get("active")]
    assert len(spikes) == 1
    # window slides past the spike -> clears, with a clearing event
    beat(800, 5, 4, now + 31.0)
    mon.tick(now=now + 31.0)
    spike = [a for a in mon.alerts("c")
             if a["alert"] == "crash_spike"][0]
    assert not spike["active"]


def test_alert_rule_findings_drop_edges():
    """findings_ring_drops is counted but was never alerted: the
    findings_drop rule fires when the fleet's counter MOVES, stays
    active while drops keep landing, and clears after a quiet
    drops_window — and a manager restart seeing a stale lifetime
    total only baselines (no re-alarm on drops that stopped hours
    ago)."""
    db, mon = _mk_monitor(drops_window=20.0, series_interval=1e9)
    now = 1000.0
    db.note_fleet_worker("c", "w1", now=now)

    def beat(execs, drops, t):
        db.note_fleet_worker("c", "w1", now=t)
        db.upsert_campaign_stats("c", "w1",
                                 _snap(execs, 1, t=t, drops=drops))

    # first observation carries a nonzero lifetime total: baseline
    # only — the drops may predate this monitor's lifetime
    beat(100, 5, now)
    mon.tick(now=now)
    assert not [a for a in mon.alerts("c")
                if a["alert"] == "findings_drop" and a["active"]]
    # the counter MOVES: rising edge, one active=True event
    beat(200, 9, now + 5.0)
    mon.tick(now=now + 5.0)
    drop = [a for a in mon.alerts("c")
            if a["alert"] == "findings_drop"][0]
    assert drop["active"]
    assert drop["details"]["findings_ring_drops_total"] == 9
    # still active inside the window, no movement
    beat(300, 9, now + 15.0)
    mon.tick(now=now + 15.0)
    assert [a for a in mon.alerts("c")
            if a["alert"] == "findings_drop"][0]["active"]
    # a quiet drops_window clears it, with a clearing event
    beat(400, 9, now + 26.0)
    mon.tick(now=now + 26.0)
    assert not [a for a in mon.alerts("c")
                if a["alert"] == "findings_drop"][0]["active"]
    # /api/fleet body + /metrics exposition both carry the rule
    # (checked BEFORE the decrease beat below overwrites the worker
    # snapshot — the stat summary reports the CURRENT heartbeat)
    from killerbeez_tpu_torch.manager.fleet import fleet_view
    body = fleet_view(db, mon.cfg, "c", monitor=mon, now=now + 26.0)
    assert "findings_drop" in {a["alert"] for a in body["alerts"]}
    assert body["workers"]["w1"]["stats"][
        "findings_ring_drops"] == 9
    text = render_fleet_metrics(db, mon.cfg, mon, now=now + 26.0)
    fams = parse_openmetrics(text)
    assert "findings_drop" in {
        lab["alert"] for _, lab, _ in
        fams["kbz_alert_active"]["samples"]}
    # a DECREASE of the merged total (a worker restarted/retired and
    # its monotone counter reset) is not a new drop: no re-fire
    beat(500, 4, now + 27.0)
    mon.tick(now=now + 27.0)
    assert not [a for a in mon.alerts("c")
                if a["alert"] == "findings_drop"][0]["active"]
    evs = [json.loads(r["payload"])
           for r in db._rows("SELECT payload FROM campaign_events "
                             "WHERE campaign='c'")]
    fires = [e for e in evs if e["type"] == "alert"
             and e.get("alert") == "findings_drop"]
    assert [e.get("active") for e in fires] == [True, False]


def test_manager_events_monotone_seq_and_dedup():
    db = ManagerDB()
    r1 = db.add_manager_event("c", "worker_dead", worker="w1")
    r2 = db.add_manager_event("c", "alert", alert="worker_death",
                              active=True)
    assert (r1["seq"], r2["seq"]) == (0, 1)
    assert r1["v"] >= 1 and "t" in r1
    rows = db.get_campaign_events("c")
    assert [r["event"]["seq"] for r in rows] == [0, 1]
    assert all(r["worker"] == "_manager" for r in rows)
    # worker streams are independent of the manager's seq space
    db.add_campaign_events("c", "w1", [
        {"v": 1, "seq": 0, "t": 5.0, "type": "crash"}])
    assert len(db.get_campaign_events("c")) == 3


def test_note_fleet_worker_registration_and_return():
    db = ManagerDB()
    assert db.note_fleet_worker("c", "w1", now=100.0) is None
    row = db.get_fleet_workers("c")[0]
    assert row["first_seen"] == 100.0
    assert row["last_seen"] == 100.0 and row["beats"] == 1
    db.set_fleet_worker_status("c", "w1", "dead")
    assert db.note_fleet_worker("c", "w1", now=200.0) == "dead"
    row = db.get_fleet_workers("c")[0]
    assert row["status"] == "healthy"
    assert row["first_seen"] == 100.0    # registration time sticks
    assert row["last_seen"] == 200.0 and row["beats"] == 2


def test_fleet_series_retention_cap():
    """The history table stays bounded: the oldest rows beyond
    max_rows are pruned at insert, cursors stay valid (ids only
    disappear from the old end)."""
    db = ManagerDB()
    ids = [db.add_fleet_sample("c", {"t": float(i), "execs": i},
                               max_rows=3) for i in range(7)]
    rows = db.get_fleet_series("c")
    assert [r["id"] for r in rows] == ids[-3:]
    assert [r["execs"] for r in rows] == [4, 5, 6]
    # other campaigns are untouched by the prune
    db.add_fleet_sample("other", {"t": 0.0})
    db.add_fleet_sample("c", {"t": 8.0}, max_rows=3)
    assert len(db.get_fleet_series("other")) == 1


def test_status_escalation_loses_to_racing_heartbeat():
    """The monitor's conditional status write: a heartbeat bumping
    last_seen between the tick's read and its write wins — no
    spurious worker_stale/worker_dead lands in the stream."""
    db = ManagerDB()
    db.note_fleet_worker("c", "w1", now=100.0)
    row = db.get_fleet_workers("c")[0]           # the tick's read
    db.note_fleet_worker("c", "w1", now=200.0)   # beat races in
    assert db.set_fleet_worker_status(
        "c", "w1", "dead", expect_last_seen=row["last_seen"]) \
        is False
    assert db.get_fleet_workers("c")[0]["status"] == "healthy"
    # unraced write applies
    row = db.get_fleet_workers("c")[0]
    assert db.set_fleet_worker_status(
        "c", "w1", "stale", expect_last_seen=row["last_seen"])
    assert db.get_fleet_workers("c")[0]["status"] == "stale"


def test_kb_fleet_json_gates_on_empty_campaign(server, capsys):
    """--json is the scripting mode: an unknown/empty campaign must
    exit nonzero there too (the documented gating contract)."""
    from killerbeez_tpu_torch.tools import fleet_tool
    rc = fleet_tool.main([f"http://127.0.0.1:{server.port}",
                          "--campaign", "ghost", "--json"])
    assert rc == 1
    assert "no workers seen" in capsys.readouterr().err


def test_worker_retirement_clears_finished_campaigns():
    """A finished campaign's workers retire after --retire-after:
    the registry row and heartbeat snapshot go away (bounded
    /metrics cardinality), the worker_death alert clears instead of
    latching forever, and fleet_series history survives."""
    db, mon = _mk_monitor(retire_after=100.0, series_interval=1.0)
    db.note_fleet_worker("c", "w1", now=1000.0)
    db.upsert_campaign_stats("c", "w1", _snap(10, 1, t=1000.0))
    mon.tick(now=1000.0)
    assert len(db.get_fleet_series("c")) == 1
    mon.tick(now=1010.0)                 # worker now dead (0.7s cfg)
    assert [a for a in mon.alerts("c")
            if a["alert"] == "worker_death"][0]["active"]
    mon.tick(now=1200.0)                 # past retire_after
    assert db.get_fleet_workers("c") == []
    assert db.get_campaign_stats("c") == []
    assert not [a for a in mon.alerts("c")
                if a["alert"] == "worker_death" and a["active"]]
    # history outlives the workers
    assert len(db.get_fleet_series("c")) >= 1
    text = render_fleet_metrics(db, mon.cfg, mon, now=1200.0)
    assert 'worker="w1"' not in text


def test_all_alert_rules_exposed_on_metrics():
    """Every declarative rule gets a kbz_alert_active series (zeros
    included) so dashboards can alert on absence too."""
    db, mon = _mk_monitor()
    db.note_fleet_worker("c", "w1", now=1000.0)
    db.upsert_campaign_stats("c", "w1", _snap(10, 1, t=1000.0))
    mon.tick(now=1000.0)
    text = render_fleet_metrics(db, mon.cfg, mon, now=1000.0)
    fams = parse_openmetrics(text)
    names = {lab["alert"] for _, lab, _ in
             fams["kbz_alert_active"]["samples"]}
    assert names == {name for name, _ in ALERT_RULES}
