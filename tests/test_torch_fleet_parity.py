"""The port's fleet tier held to the JAX package's: the same rows,
request sequences, clock and seeds go to both packages' objects, and
what comes back must be equal.

Covered: the entry validator's verdicts and the entries it builds, the
quarantine store (each package reads what the other wrote), peer bans,
the chaos engine's firing, the manager DB's rows, the REST API's
responses (fleet views, alerts and /metrics included), degraded mode and
the admission journal (each package replays the other's journal),
reconcile's tier fold, ``format_cmdline``, and a scripted gossip fleet
with a poisoning peer (run per package and compared, then run mixed)."""

import base64
import json
import random
import sqlite3
import time
import urllib.error
import urllib.request

import pytest

from killerbeez_tpu.corpus import quarantine as j_quarantine
from killerbeez_tpu.corpus import store as j_store
from killerbeez_tpu.hybrid import reconcile as j_reconcile
from killerbeez_tpu.manager import api as j_api
from killerbeez_tpu.manager import db as j_db
from killerbeez_tpu.manager import fleet as j_fleet
from killerbeez_tpu.manager import fuzzer_cmd as j_fuzzer_cmd
from killerbeez_tpu.manager import journal as j_journal
from killerbeez_tpu.resilience import chaos as j_chaos
from killerbeez_tpu.resilience import fleetsim as j_fleetsim
from killerbeez_tpu_torch.corpus import quarantine as p_quarantine
from killerbeez_tpu_torch.corpus import store as p_store
from killerbeez_tpu_torch.hybrid import reconcile as p_reconcile
from killerbeez_tpu_torch.manager import api as p_api
from killerbeez_tpu_torch.manager import db as p_db
from killerbeez_tpu_torch.manager import fleet as p_fleet
from killerbeez_tpu_torch.manager import fuzzer_cmd as p_fuzzer_cmd
from killerbeez_tpu_torch.manager import journal as p_journal
from killerbeez_tpu_torch.resilience import chaos as p_chaos
from killerbeez_tpu_torch.resilience import fleetsim as p_fleetsim
from killerbeez_tpu_torch.utils.fileio import md5_hex

PKGS = {
    "jax": dict(quarantine=j_quarantine, store=j_store,
                reconcile=j_reconcile, api=j_api, db=j_db, fleet=j_fleet,
                fuzzer_cmd=j_fuzzer_cmd, journal=j_journal, chaos=j_chaos,
                fleetsim=j_fleetsim),
    "port": dict(quarantine=p_quarantine, store=p_store,
                 reconcile=p_reconcile, api=p_api, db=p_db, fleet=p_fleet,
                 fuzzer_cmd=p_fuzzer_cmd, journal=p_journal, chaos=p_chaos,
                 fleetsim=p_fleetsim),
}

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    j_chaos.configure(None)
    p_chaos.configure(None)


@pytest.fixture
def clock(monkeypatch):
    """``time.time`` frozen at a settable value, for both packages (each
    reads the wall clock only through ``time.time``)."""
    now = [T0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


def _row(buf, sig=None, **over):
    sig = sorted(sig or [])
    cov = p_store.coverage_hash(sig or None, buf)
    row = {"worker": "w", "md5": md5_hex(buf), "cov_hash": cov,
           "content_b64": base64.b64encode(buf).decode(),
           "meta": {"sig": sig or None, "md5": md5_hex(buf),
                    "cov_hash": cov, "seq": 0, "source": "local"}}
    row.update(over)
    return row


def _entry_fields(entry):
    if entry is None:
        return None
    return {k: getattr(entry, k) for k in type(entry).__slots__}


# -- validator, quarantine, bans, chaos ---------------------------------


def _rows_to_validate():
    rng = random.Random(12)
    honest = []
    for i in range(24):
        buf = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40)))
        sig = rng.sample(range(1 << 16), rng.randrange(0, 6))
        r = _row(buf, sig)
        if i % 3 == 0:
            r["meta"].update(edge_hits={str(s): i + 1 for s in sig},
                             selections=i / 3, finds=1.0,
                             parent="p" * (i % 5), tier="tpu")
        honest.append(r)
    base = _row(b"DATA", [1])
    poison = [
        "not a dict", None, 42, [],
        {**base, "content_b64": 7},
        {**base, "content_b64": "!!not-b64!!"},
        {**base, "content_b64": ""},
        {**base, "md5": "zz" * 16},
        {**base, "md5": "0" * 32},
        {**base, "meta": "nope"},
        {**base, "meta": {**base["meta"], "sig": ["x"]}},
        {**base, "meta": {**base["meta"], "sig": 3}},
        {**base, "meta": {**base["meta"], "edge_hits": {"a": "b"}}},
        {**base, "meta": {**base["meta"], "edge_hits": [1, 2]}},
        {**base, "meta": {**base["meta"], "selections": "lots"}},
        {**base, "meta": {**base["meta"], "seq": "NaNistan"}},
        {**base, "cov_hash": "sig:forged"},
        {**base, "cov_hash": {"not": "a string"}},
        {"content_b64": None},
        {"content_b64": "QQ=="},
        _row(b"X" * 17, [1]),
        {**base, "meta": {**base["meta"], "parent": "p" * 100}},
    ]
    return honest + poison


@pytest.mark.parametrize("caps", [{}, {"max_content_bytes": 16,
                                       "max_meta_bytes": 64}])
def test_validator_verdicts_and_entries_match_jax(caps, clock):
    rows = _rows_to_validate()
    for executor in (None, lambda buf: [1] if len(buf) % 2 else [1, 2]):
        jv = j_quarantine.EntryValidator(executor=executor, **caps)
        pv = p_quarantine.EntryValidator(executor=executor, **caps)
        for row in rows:
            je, jr = jv.validate(row)
            pe, pr = pv.validate(row)
            assert pr == jr, row
            assert _entry_fields(pe) == _entry_fields(je), row
    for row in rows[:24]:
        sig = row["meta"]["sig"]
        buf = base64.b64decode(row["content_b64"])
        assert p_store.coverage_hash(sig, buf) == \
            j_store.coverage_hash(sig, buf)


def test_quarantine_store_reads_what_the_other_wrote(tmp_path, clock):
    puts = [(b"BAD", "integrity:cov_hash-mismatch", "evil"),
            (b"BAD", "integrity:cov_hash-mismatch", "evil"),
            (b"WORSE", "schema:sig", None),
            (b"\x00\xff" * 9, "size:content", "p2")]
    loads = {}
    for name, mods in PKGS.items():
        q = mods["quarantine"].QuarantineStore(str(tmp_path / name))
        for i, (buf, reason, peer) in enumerate(puts):
            clock[0] = T0 + i
            q.put(buf, reason, peer=peer)
        loads[name] = q.load()
        assert len(q) == 3
    assert loads["port"] == loads["jax"]
    for writer, reader in (("jax", "port"), ("port", "jax")):
        q = PKGS[reader]["quarantine"].QuarantineStore(str(tmp_path / writer))
        assert q.load() == loads[writer] and len(q) == 3
    jdir = tmp_path / "jax" / j_quarantine.QUARANTINE_DIR
    pdir = tmp_path / "port" / p_quarantine.QUARANTINE_DIR
    assert sorted(p.name for p in jdir.iterdir()) == \
        sorted(p.name for p in pdir.iterdir())
    for p in jdir.iterdir():
        assert (pdir / p.name).read_bytes() == p.read_bytes()


def test_peer_bans_match_jax():
    def trace(mod):
        now = [1000.0]
        bans = mod.PeerBans(threshold=3, base_s=10.0, cap_s=100.0,
                            rng=random.Random(7), time_fn=lambda: now[0])
        out = []
        script = [("strike", "evil", 1), ("strike", "evil", 1),
                  ("strike", "evil", 1), ("tick", 5.0, 0),
                  ("strike", "evil", 3), ("tick", 120.0, 0),
                  ("strike", "evil", 3), ("strike", "flaky", 2),
                  ("clean", "flaky", 0), ("strike", "flaky", 1),
                  ("strike", "flaky", 2), ("tick", 1000.0, 0),
                  ("strike", "evil", 5), ("strike", "evil", 3)]
        for op, a, b in script:
            if op == "tick":
                now[0] += a
            elif op == "clean":
                bans.clean(a)
            else:
                out.append(bans.strike(a, n=b))
            out.append((bans.is_banned("evil"), bans.is_banned("flaky"),
                        dict(bans.banned_until), dict(bans.strikes),
                        bans.active(), bans.total_bans))
        return out

    assert trace(p_quarantine) == trace(j_quarantine)


def test_chaos_engine_fires_like_jax():
    spec = {"faults": [
        {"point": "manager_rpc", "mode": "partition", "every": 2,
         "match": "127.0.0.1:9999"},
        {"point": "manager_rpc", "mode": "http500", "hit": 3,
         "match": "peerX"},
        {"point": "device_dispatch", "mode": "raise", "every": 3},
        {"point": "manager_db_write", "mode": "enospc", "hit": 2,
         "match": "corpus_entries"},
        {"point": "persist", "mode": "raise", "prob": 0.5}]}
    calls = [("manager_rpc", {"url": u}) for u in (
        "http://127.0.0.1:9999/a", "http://peerX/a", "http://other/",
        "http://127.0.0.1:9999/b", "http://peerX/b", "http://peerX/c",
        "http://127.0.0.1:9999/c", "http://peerX/d")]
    calls += [("device_dispatch", {})] * 7
    calls += [("manager_db_write", {"url": "INSERT INTO " + t}) for t in (
        "corpus_entries", "jobs", "corpus_entries", "corpus_entries")]
    calls += [("persist", {})] * 12

    def trace(mod):
        eng = mod.configure(dict(spec, seed=5))
        out = []
        for point, ctx in calls:
            try:
                mod.chaos_point(point, **ctx)
                out.append(None)
            except BaseException as e:      # noqa: BLE001 - the fault
                out.append((type(e).__name__, str(e)))
        out.append([(f.seen, f.fired) for f in eng.faults])
        mod.configure(None)
        return out

    got = trace(p_chaos)
    assert got == trace(j_chaos)
    assert sum(x is not None for x in got[:-1]) > 0


# -- the manager: DB, REST API, degraded mode, journal ------------------


def _dump(db):
    conn = db._conn()
    tables = [r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table' "
        "AND name NOT LIKE 'sqlite_%' ORDER BY name")]
    return {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
            for t in tables}


def _db_script(db, clock):
    out = []
    t1 = db.create_target("tlv")
    t2 = db.create_target("win", "windows_x86_64", "C:/t.exe")
    db.set_config("timeout", "5")
    db.set_config("timeout", "9", t1)
    out += [db.get_targets(), db.lookup_config("timeout", t1),
            db.lookup_config("timeout", t2), db.lookup_config("nope")]
    j1 = db.create_job(t1, "file", "jit_harness", "havoc", 4096, "s.bin",
                       instrumentation_opts='{"target": "tlvstack_vm"}',
                       mutator_opts='{"seed": 3}')
    db.create_job(t2, "stdin", "debug", "bit_flip", 10, "")
    clock[0] += 5
    out += [db.claim_job("w1"), db.claim_job("w2"), db.claim_job("w3")]
    out.append(db.add_result(j1, "crash", "crashes/x", "sig 11"))
    db.finish_job(j1, "done", "state")
    clock[0] += 100
    out += [db.requeue_stale_jobs(50), db.get_jobs(), db.get_jobs("queued"),
            db.get_results(), db.get_results(j1)]
    out += [db.add_file("seed", b"\x00\x01"), db.get_file(1),
            db.add_instrumentation_state(t1, "abc"),
            db.get_instrumentation_states(t1)]
    db.add_tracer_info(t1, "a", [1, 2, 3])
    db.add_tracer_info(t1, "b", [3, 4])
    out.append(db.get_tracer_info(t1))
    for w, n in (("w1", 10), ("w2", 20), ("w1", 30)):
        clock[0] += 1
        db.upsert_campaign_stats("c", w, {"counters": {"execs": n}})
        db.note_fleet_worker("c", w, meta={"pid": n})
    db.note_fleet_worker("c", "w3", meta={"gossip": "http://a:1"},
                         now=T0)
    out += [db.get_campaign_stats("c"), db.get_fleet_workers("c"),
            db.get_fleet_workers(), db.fleet_campaigns()]
    db.set_fleet_worker_status("c", "w2", "dead")
    for i in range(4):
        db.add_fleet_sample("c", {"t": T0 + i, "execs": i * 100,
                                  "n_workers": 2})
    out += [db.get_fleet_series("c", 0, 2), db.fleet_series_latest_id("c")]
    out.append(db.add_campaign_events("c", "w1", [
        {"seq": 0, "t": 1.0, "type": "crash"},
        {"seq": 1, "t": 2.0, "type": "new_path"}]))
    out.append(db.add_campaign_events("c", "w1", [
        {"seq": 1, "t": 2.0, "type": "new_path"}]))
    db.add_manager_event("c", "worker_death", worker="w2")
    out += [db.get_campaign_events("c", 0), db.events_latest_id("c")]
    for buf, sig, w in ((b"ONE", [1], "w1"), (b"TWO", [2], "w2"),
                        (b"ONE", [1], "w2")):
        cov = p_store.coverage_hash(sig, buf)
        out.append(db.add_corpus_entry("c", cov, md5_hex(buf), w, buf,
                                       {"sig": sig}))
    out += [db.get_corpus_entries("c", 0), db.get_corpus_entries("c", 1),
            db.get_corpus_entries("c", 0, "w1"), db.corpus_latest_id("c")]
    clock[0] += 200_000
    out += [db.retire_fleet_workers(clock[0] - 1000), db.consume_recovery(),
            db.degraded]
    return out


def test_manager_db_rows_match_jax(clock):
    outs, dumps = {}, {}
    for name, mods in PKGS.items():
        clock[0] = T0
        db = mods["db"].ManagerDB()
        outs[name] = _db_script(db, clock)
        dumps[name] = _dump(db)
        db.close()
    assert outs["port"] == outs["jax"]
    assert dumps["port"] == dumps["jax"]


def _http(url, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url + path, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _corpus_post(buf, sig, worker):
    cov = p_store.coverage_hash(sig, buf)
    return {"worker": worker, "md5": md5_hex(buf), "cov_hash": cov,
            "content_b64": base64.b64encode(buf).decode(),
            "meta": {"sig": sig, "md5": md5_hex(buf), "cov_hash": cov}}


def _snap(execs, paths, crashes=0, drops=0):
    return {"counters": {"execs": execs, "new_paths": paths,
                         "crashes": crashes, "unique_crashes": crashes,
                         "findings_ring_drops": drops,
                         "sync_quarantined": 1, "gossip_entries_in": 2},
            "gauges": {"execs_per_sec_ema": 100.0 + execs / 1000,
                       "corpus_seen": paths, "peers_banned_active": 0}}


API_SCRIPT = [
    ("POST", "/api/target", {"name": "tlv"}),
    ("POST", "/api/target", {"name": "win", "platform": "windows_x86_64"}),
    ("GET", "/api/target", None),
    ("POST", "/api/config", {"name": "timeout", "value": "5"}),
    ("POST", "/api/config", {"name": "timeout", "value": "9",
                             "target_id": 1}),
    ("GET", "/api/config?name=timeout&target_id=1", None),
    ("GET", "/api/config?name=timeout", None),
    ("POST", "/api/job", {"target_id": 1, "driver": "file",
                          "instrumentation": "jit_harness",
                          "mutator": "havoc", "iterations": 4096,
                          "seed_file": "/seeds/a b.bin",
                          "instrumentation_opts":
                              '{"target": "tlvstack_vm"}',
                          "mutator_opts": '{"seed": 3}'}),
    ("POST", "/api/job", {"target_id": 2, "driver": "file",
                          "instrumentation": "debug",
                          "mutator": "bit_flip",
                          "seed_file": 'C:\\s "q".bin'}),
    ("GET", "/api/job", None),
    ("GET", "/api/job?status=queued", None),
    ("POST", "/api/work/claim", {"worker": "w1"}),
    ("POST", "/api/work/claim", {"worker": "w2"}),
    ("POST", "/api/work/claim", {"worker": "w3"}),
    ("GET", "/api/job/1", None),
    ("GET", "/api/job/99", None),
    ("POST", "/api/job/1/results", {"result_type": "crash",
                                    "repro_file": "crashes/x",
                                    "crash_info": "sig 11"}),
    ("GET", "/api/job/1/results", None),
    ("GET", "/api/results", None),
    ("POST", "/api/work/1/finish", {"status": "done",
                                    "mutator_state": "st"}),
    ("GET", "/api/job?status=done", None),
    ("POST", "/api/file", {"name": "seed",
                           "content_b64": base64.b64encode(
                               b"\x00SEED").decode()}),
    ("GET", "/api/file/1", None),
    ("GET", "/api/file/7", None),
    ("POST", "/api/state", {"target_id": 1, "state": "abc"}),
    ("GET", "/api/state/1", None),
    ("POST", "/api/tracer_info", {"target_id": 1, "input_file": "a",
                                  "edges": [1, 2, 3]}),
    ("POST", "/api/tracer_info", {"target_id": 1, "input_file": "b",
                                  "edges": [3, 4]}),
    ("POST", "/api/tracer_info", {"target_id": 1, "input_file": "c",
                                  "edges": [1, 2]}),
    ("POST", "/api/minimize", {"target_id": 1}),
    ("POST", "/api/stats/c1", {"worker": "w1", "snapshot": _snap(100, 3),
                               "meta": {"pid": 1}}),
    ("POST", "/api/stats/c1", {"worker": "w2", "snapshot": _snap(50, 1, 1),
                               "meta": {"pid": 2, "tier": "native"}}),
    ("GET", "/api/stats/c1", None),
    ("POST", "/api/corpus/c1", _corpus_post(b"ONE", [1], "w1")),
    ("POST", "/api/corpus/c1", _corpus_post(b"TWO", [2, 9], "w2")),
    ("POST", "/api/corpus/c1", _corpus_post(b"ONE", [1], "w2")),
    ("POST", "/api/corpus/c1", _corpus_post(b"THREE", [], "w1")),
    ("GET", "/api/corpus/c1?since=0", None),
    ("GET", "/api/corpus/c1?since=2", None),
    ("GET", "/api/corpus/c1?since=0&exclude=w1", None),
    ("GET", "/api/corpus/empty?since=0", None),
    ("POST", "/api/events/c1", {"worker": "w1", "events": [
        {"seq": 0, "t": 1.0, "type": "crash", "md5": "x"},
        {"seq": 1, "t": 2.0, "type": "new_path"}]}),
    ("POST", "/api/events/c1", {"worker": "w1", "events": [
        {"seq": 1, "t": 2.0, "type": "new_path"}]}),
    ("GET", "/api/events/c1?since=0", None),
    ("GET", "/api/events/c1?since=1", None),
    ("POST", "/api/peers/c1", {"worker": "w1",
                               "endpoint": "http://127.0.0.1:7001"}),
    ("POST", "/api/peers/c1", {"worker": "w2",
                               "endpoint": "http://127.0.0.1:7002"}),
    ("POST", "/api/peers/c1", {"worker": "wX",
                               "endpoint": "gopher://nope"}),
    ("GET", "/api/peers/c1", None),
    ("GET", "/api/peers/c1?exclude=w1", None),
    ("GET", "/api/health", None),
    ("GET", "/api/fleet", None),
    ("GET", "/api/fleet/c1", None),
    ("GET", "/metrics", None),
    ("GET", "/api/nope", None),
]

#: (seconds to advance, heartbeats posted before the monitor ticks); w2
#: stops beating, paths go flat, crashes spike, ring drops move
TICKS = [
    (11, [("w1", _snap(200, 5)), ("w2", _snap(90, 2, 1))]),
    (11, [("w1", _snap(400, 6, 2)), ("w2", _snap(120, 2, 3))]),
    (20, [("w1", _snap(800, 6, 20, drops=3))]),
    (70, [("w1", _snap(1600, 6, 21, drops=3))]),
    (400, [("w1", _snap(3200, 6, 21, drops=3))]),
    (1000, [("w1", _snap(6400, 6, 21, drops=3))]),
]

READS = ["/api/fleet", "/api/fleet/c1", "/api/fleet/c1/series?since=0",
         "/api/fleet/c1/series?since=0&limit=2&format=plot",
         "/api/events/c1?since=0", "/api/peers/c1", "/api/health",
         "/metrics"]


def _api_run(mods, clock, **server_kw):
    clock[0] = T0
    cfg = mods["fleet"].FleetConfig(monitor_interval=0.0,
                                    series_interval=10.0)
    s = mods["api"].ManagerServer(port=0, fleet=cfg, **server_kw)
    s.start()
    url = f"http://127.0.0.1:{s.port}"
    out = []
    try:
        for method, path, payload in API_SCRIPT:
            clock[0] += 0.5
            out.append((method, path, _http(url, method, path, payload)))
        for dt, beats in TICKS:
            clock[0] += dt
            for w, snap in beats:
                _http(url, "POST", "/api/stats/c1",
                      {"worker": w, "snapshot": snap})
            s.monitor.tick(now=clock[0])
            for path in READS:
                out.append(("GET", path, _http(url, "GET", path)))
        dump = _dump(s.db)
    finally:
        s.stop()
    return out, dump


def test_manager_api_responses_match_jax(clock):
    jout, jdump = _api_run(PKGS["jax"], clock)
    pout, pdump = _api_run(PKGS["port"], clock)
    assert len(pout) == len(jout)
    for (m, path, want), (_, _, got) in zip(jout, pout):
        # the one intended difference: a job's command runs its own CLI
        got = got[:2] + (got[2].replace(b"killerbeez_tpu_torch.fuzzer",
                                        b"killerbeez_tpu.fuzzer"),)
        assert got == want, f"{m} {path}"
    assert pdump == jdump
    # the script reached the alert rules and the classifier
    fleet = json.loads(pout[-len(READS) + 1][2][2])
    active = {a["alert"] for a in fleet["alerts"] if a["active"]}
    assert "worker_death" in active and len(active) >= 2, fleet["alerts"]
    assert {w["status"] for w in fleet["workers"].values()} >= {"dead"}


DEGRADED_SCRIPT = [
    (None, "POST", "/api/corpus/c1", _corpus_post(b"ONE", [1], "w1")),
    ({"faults": [{"point": "manager_db_write", "mode": "enospc",
                  "every": 1, "match": "corpus_entries"}]},
     "POST", "/api/corpus/c1", _corpus_post(b"TWO", [2], "w1")),
    (None, "GET", "/api/corpus/c1?since=0", None),
    (None, "GET", "/api/health", None),
    (None, "GET", "/api/fleet", None),
    ({"faults": [{"point": "manager_db_write", "mode": "enospc",
                  "every": 1, "match": "campaign_events"}]},
     "POST", "/api/events/c1", {"worker": "w1", "events": [
         {"seq": 0, "t": 1.0, "type": "crash", "md5": "x"}]}),
    ({"faults": [{"point": "manager_db_write", "mode": "enospc",
                  "every": 1}]},
     "POST", "/api/peers/c1", {"worker": "w1",
                               "endpoint": "http://127.0.0.1:7001"}),
    (None, "GET", "/api/health", None),
    ("off", "POST", "/api/corpus/c2", _corpus_post(b"KEEP", [5], "w2")),
    (None, "GET", "/api/health", None),
    ({"faults": [{"point": "manager_db_write", "mode": "enospc",
                  "every": 1}]},
     "POST", "/api/corpus/c2", _corpus_post(b"LATE", [6], "w2")),
]


def test_degraded_mode_and_journal_replay_match_jax(tmp_path, clock):
    """The same faults under both managers give the same responses and
    the same journal file; each package's manager then boots on the
    other's DB and journal, replays it, and holds the same rows."""
    outs = {}
    for name, mods in PKGS.items():
        clock[0] = T0
        root = tmp_path / name
        root.mkdir()
        s = mods["api"].ManagerServer(
            port=0, db_path=str(root / "m.db"),
            fleet=mods["fleet"].FleetConfig(monitor_interval=0.0))
        s.start()
        url = f"http://127.0.0.1:{s.port}"
        out = []
        try:
            for spec, method, path, payload in DEGRADED_SCRIPT:
                clock[0] += 1
                if spec == "off":
                    mods["chaos"].configure(None)
                elif spec is not None:
                    mods["chaos"].configure(spec)
                out.append(_http(url, method, path, payload))
        finally:
            mods["chaos"].configure(None)
            s.stop()
        outs[name] = out
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][1][2])["journaled"] is True
    assert (tmp_path / "port" / "m.db.journal").read_bytes() == \
        (tmp_path / "jax" / "m.db.journal").read_bytes()
    dumps = {}
    for name, files in (("jax", "port"), ("port", "jax")):
        s = PKGS[name]["api"].ManagerServer(
            port=0, db_path=str(tmp_path / files / "m.db"))
        try:
            dumps[name] = _dump(s.db)
            assert s.journal.uncommitted == 0
            assert {r["md5"] for r in s.db.get_corpus_entries("c2", 0)} \
                == {md5_hex(b"KEEP"), md5_hex(b"LATE")}
        finally:
            s.stop()
    assert dumps["port"] == dumps["jax"]


def test_journal_records_replay_across_packages(tmp_path, clock):
    """Records appended by one package's AdmissionJournal (a torn tail
    included) replay into the other package's ManagerDB as into its
    own."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        path = tmp_path / f"{writer}.journal"
        j = PKGS[writer]["journal"].AdmissionJournal(str(path))
        for i in range(3):
            buf = b"E%d" % i
            j.append_corpus("c", p_store.coverage_hash([i], buf),
                            md5_hex(buf), "w", buf, {"sig": [i]})
        j.append_events("c", "w", [{"seq": 0, "t": 1.0, "type": "crash"}])
        j.close()
        with open(path, "a") as f:
            f.write('{"kind": "corpus", "campa')     # torn tail
        text = path.read_bytes()
        results = {}
        for name in (writer, reader):
            path.write_bytes(text)
            db = PKGS[name]["db"].ManagerDB()
            jr = PKGS[name]["journal"].AdmissionJournal(str(path))
            results[name] = (jr.replay(db), _dump(db))
            jr.close()
            db.close()
        assert results[reader] == results[writer]
        assert results[reader][0][0] >= 3


def test_fleet_functions_match_jax():
    cfg_j, cfg_p = j_fleet.FleetConfig(), p_fleet.FleetConfig()
    for age in (0.0, 14.9, 15.0, 30.0, 59.9, 60.0, 1e6, -1.0):
        assert p_fleet.classify(age, cfg_p) == j_fleet.classify(age, cfg_j)
    for snap in (_snap(10, 1), _snap(0, 0, 5, drops=2), {}, {"counters": {}},
                 {"gauges": {"execs_per_sec_ema": 3.5}}):
        assert p_fleet.worker_stats_summary(snap) == \
            j_fleet.worker_stats_summary(snap)


def test_reconcile_fold_matches_jax():
    rows = [{"worker": "w1", "meta": {"tier": "tpu"}},
            {"worker": "w2", "meta": {"tier": "native"}},
            {"name": "w3", "meta": None}, {"worker": None},
            {"worker": "w4", "meta": {"tier": ""}},
            {"worker": "w5", "meta": {"tier": "native"}}]
    stats = {"w1": {"snapshot": _snap(100, 3)}, "w2": _snap(50, 1, 2),
             "w5": {"snapshot": {"counters": {"hybrid_validations": 4,
                                              "hybrid_confirmed": 1},
                                 "gauges": {"execs_per_sec_ema": 9.0}}}}
    statuses = {"w1": "healthy", "w2": "dead", "w5": "stale"}
    assert p_reconcile.fold_tiers(rows, stats, statuses) == \
        j_reconcile.fold_tiers(rows, stats, statuses)
    for meta in (None, {}, {"tier": "x"}, {"tier": 3}, "tier"):
        assert p_reconcile.tier_of(meta) == j_reconcile.tier_of(meta)
    merged = {"counters": {"hybrid_validations": 5, "hybrid_flaky": 1,
                           "hybrid_proxy_gaps": 2},
              "gauges": {"validation_queue_depth": 3,
                         "validation_queue_age": 1.5}}
    for m in (merged, {}, None):
        assert p_reconcile.validation_summary(m) == \
            j_reconcile.validation_summary(m)


def test_format_cmdline_matches_jax():
    jobs = [{"driver": "file", "instrumentation": "jit_harness",
             "mutator": "havoc", "iterations": 4096,
             "seed_file": "/seeds/a b.bin",
             "instrumentation_opts": '{"target": "tlv stack"}',
             "mutator_opts": "{\"seed\": 'x'}",
             "mutator_state_file": "m.state"},
            {"driver": "stdin", "instrumentation": "debug",
             "mutator": "bit_flip", "driver_opts": 'a"b',
             "instrumentation_state_file": "i.state"}]
    for job in jobs:
        for plat in ("linux_x86_64", "windows_x86_64"):
            for seed in (None, "C:\\x y.bin"):
                kw = dict(platform=plat, program="kbz", seed_file=seed)
                assert p_fuzzer_cmd.format_cmdline(job, **kw) == \
                    j_fuzzer_cmd.format_cmdline(job, **kw)
        assert p_fuzzer_cmd.format_cmdline(job).replace(
            "killerbeez_tpu_torch.fuzzer", "killerbeez_tpu.fuzzer") == \
            j_fuzzer_cmd.format_cmdline(job)


# -- gossip: a scripted fleet per package, then a mixed one -------------


def _fleet_run(mods, tmp_path, name):
    """Four workers and a poisoning peer on one manager, driven round by
    round: every worker's store, quarantine, counters and bans."""
    s = mods["api"].ManagerServer(port=0)
    s.start()
    url = f"http://127.0.0.1:{s.port}"
    sim = mods["fleetsim"]
    fleet = sim.SimFleet(4, "g", url, str(tmp_path / name), fanout=2,
                         seed=3)
    evil = sim.SimWorker("evil", "g", url, str(tmp_path / name), seed=9)
    try:
        evil.discover(1)
        evil.poison(2)                  # below the ban threshold
        trace = []
        for r in range(4):
            fleet.round(discoveries=1 if r < 2 else 0, skip={r % 4})
            evil.round()
            trace.append([sorted(w.cov_hashes()) for w in fleet.workers])
        target = fleet.union() | {e.cov_hash for e in evil.store.load()}
        rounds = fleet.rounds_until_converged(target, max_rounds=8)
        keys = ("sync_quarantined", "peers_banned", "corpus_synced_in")
        state = [(sorted(w.cov_hashes()),
                  [(md5, rec["reason"], rec["peer"]) for md5, rec in
                   mods["quarantine"].QuarantineStore(w.store.root).load()],
                  {k: w.registry.counters.get(k, 0) for k in keys},
                  sorted(w.sync.bans.banned_until),
                  dict(w.sync.bans.strikes), w.sync.bans.total_bans)
                 for w in fleet.workers]
        corpus = [(r["cov_hash"], r["worker"])
                  for r in s.db.get_corpus_entries("g", 0)]
        return trace, rounds, state, sorted(corpus), target
    finally:
        fleet.close()
        evil.close()
        s.stop()


def test_gossip_fleet_matches_jax(tmp_path):
    j = _fleet_run(PKGS["jax"], tmp_path, "jax")
    p = _fleet_run(PKGS["port"], tmp_path, "port")
    assert p[1] < 8                         # converged
    assert p[:4] == j[:4]
    assert all(st[0] == sorted(p[4]) for st in p[2])
    assert sum(st[2]["sync_quarantined"] for st in p[2]) > 0


@pytest.mark.parametrize("hub", ["jax", "port"])
def test_mixed_gossip_fleet_converges_and_quarantines(tmp_path, hub):
    """JAX and port workers alternate on one manager of either package:
    every store converges to the union, and the poisoning peer (a worker
    of the other package than the first honest one) is quarantined."""
    s = PKGS[hub]["api"].ManagerServer(port=0)
    s.start()
    url = f"http://127.0.0.1:{s.port}"
    names = ("jax", "port", "jax", "port")
    workers = [PKGS[pkg]["fleetsim"].SimWorker(
        f"w{i}{pkg}", "g", url, str(tmp_path), seed=i)
        for i, pkg in enumerate(names)]
    evil = PKGS["port"]["fleetsim"].SimWorker("evil", "g", url,
                                              str(tmp_path), seed=7)
    try:
        forged = set(evil.poison(3))
        for w in workers:
            w.discover(2)
        target = set().union(*(w.cov_hashes() for w in workers))
        for _ in range(8):
            evil.round()
            for w in workers:
                w.round()
            if all(target <= w.cov_hashes() for w in workers):
                break
        for w in workers:
            assert target <= w.cov_hashes(), w.name
            assert not forged & w.cov_hashes(), w.name
        assert sum(w.registry.counters.get("sync_quarantined", 0)
                   for w in workers) > 0
        got = {r["worker"] for r in s.db.get_corpus_entries("g", 0)}
        assert {w.name for w in workers} <= got
    finally:
        for w in workers + [evil]:
            w.close()
        s.stop()


def test_sqlite_rows_written_by_jax_db_read_by_port(tmp_path, clock):
    """A file DB filled through the JAX ManagerDB answers the port's
    queries as it answers the JAX package's own."""
    path = str(tmp_path / "m.db")
    db = j_db.ManagerDB(path)
    _db_script(db, clock)
    db.close()
    reads = {}
    for name, mods in PKGS.items():
        db = mods["db"].ManagerDB(path)
        reads[name] = (db.get_targets(), db.get_jobs(), db.get_results(),
                       db.get_campaign_stats("c"), db.get_fleet_workers(),
                       db.get_fleet_series("c", 0),
                       db.get_campaign_events("c", 0),
                       db.get_corpus_entries("c", 0),
                       db.get_tracer_info(1), db.lookup_config("timeout", 1))
        db.close()
    assert reads["port"] == reads["jax"]
    assert sqlite3.connect(path).execute(
        "PRAGMA journal_mode").fetchone()[0] == "wal"
