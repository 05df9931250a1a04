"""The port's partition-tolerant fleet tier, part 1 (killerbeez_tpu_torch/
corpus/gossip.py + quarantine.py, manager durability), the counterpart
of tests/test_gossip.py on the CPU: entry-validator and
peer-ban units, the gossip sidecar's cursor API, hub-free peer
exchange, the manager's WAL/locked-retry/degraded read-only mode and
the write-ahead admission journal's SIGKILL-equivalent replay.

The fleet-scale convergence gates live in test_torch_fleet_chaos.py."""

import base64
import json
import os
import random
import urllib.request

import pytest

from killerbeez_tpu_torch.corpus import (
    CorpusEntry, CorpusStore, EntryValidator, GossipSidecar,
    GossipSync, PeerBans, QuarantineStore,
)
from killerbeez_tpu_torch.corpus.store import coverage_hash
from killerbeez_tpu_torch.manager.api import ManagerServer
from killerbeez_tpu_torch.manager.db import ManagerDB, ManagerWriteError
from killerbeez_tpu_torch.resilience import chaos
from killerbeez_tpu_torch.resilience.fleetsim import SimWorker
from killerbeez_tpu_torch.utils.fileio import md5_hex


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    chaos.configure(None)


def _row(buf: bytes, sig=None, **over):
    sig = sorted(sig or [])
    meta = {"sig": sig or None, "md5": md5_hex(buf),
            "cov_hash": coverage_hash(sig or None, buf),
            "seq": 0, "source": "local"}
    row = {"worker": "w", "md5": md5_hex(buf),
           "cov_hash": coverage_hash(sig or None, buf),
           "content_b64": base64.b64encode(buf).decode(),
           "meta": meta}
    row.update(over)
    return row


# -- validator units ----------------------------------------------------


def test_validator_accepts_honest_row():
    v = EntryValidator()
    entry, reason = v.validate(_row(b"HELLO", [3, 5]))
    assert reason is None
    assert entry.buf == b"HELLO" and entry.sig == [3, 5]
    assert entry.cov_hash == coverage_hash([3, 5], b"HELLO")


@pytest.mark.parametrize("mutate,expect", [
    (lambda r: "not a dict", "schema:not-a-dict"),
    (lambda r: {**r, "content_b64": 7}, "schema:content_b64"),
    (lambda r: {**r, "content_b64": "!!not-b64!!"},
     "schema:content_b64-decode"),
    (lambda r: {**r, "content_b64": ""}, "schema:empty-content"),
    (lambda r: {**r, "md5": "zz" * 16}, "schema:md5"),
    (lambda r: {**r, "md5": "0" * 32}, "integrity:md5-mismatch"),
    (lambda r: {**r, "meta": "nope"}, "schema:meta"),
    (lambda r: {**r, "meta": {**r["meta"], "sig": ["x"]}},
     "schema:sig"),
    (lambda r: {**r, "meta": {**r["meta"], "edge_hits": {"a": "b"}}},
     "schema:edge_hits"),
    (lambda r: {**r, "meta": {**r["meta"], "selections": "lots"}},
     "schema:selections"),
    (lambda r: {**r, "cov_hash": "sig:forged"},
     "integrity:cov_hash-mismatch"),
])
def test_validator_rejects_poison(mutate, expect):
    entry, reason = EntryValidator().validate(mutate(_row(b"DATA",
                                                          [1])))
    assert entry is None and reason == expect


def test_validator_size_caps():
    v = EntryValidator(max_content_bytes=16, max_meta_bytes=64)
    assert v.validate(_row(b"X" * 17, [1]))[1] == "size:content"
    big_meta = _row(b"OK", [1])
    big_meta["meta"]["parent"] = "p" * 100
    assert v.validate(big_meta)[1] == "size:meta"


def test_validator_reexec_hook():
    """With a local executor the claimed signature must reproduce."""
    v = EntryValidator(executor=lambda buf: [1, 2])
    ok, reason = v.validate(_row(b"GOOD", [1, 2]))
    assert reason is None and ok is not None
    bad, reason = v.validate(_row(b"EVIL", [9]))
    assert bad is None and reason == "integrity:reexec-sig-mismatch"


def test_validator_never_raises_on_hostile_rows():
    """The validator IS the trust boundary: no input may crash it."""
    v = EntryValidator()
    hostile = [
        None, 42, [], {"content_b64": None},
        {"content_b64": "QQ==", "meta": {"sig": 3}},
        {"content_b64": "QQ==", "meta": {"seq": "NaNistan"}},
        {"content_b64": "QQ==", "cov_hash": {"not": "a string"}},
        {"content_b64": "QQ==", "meta": {"edge_hits": [1, 2]}},
    ]
    for row in hostile:
        entry, reason = v.validate(row)
        assert entry is None and isinstance(reason, str)


def test_quarantine_store_roundtrip(tmp_path):
    q = QuarantineStore(str(tmp_path))
    q.put(b"BAD", "integrity:cov_hash-mismatch", peer="evil")
    q.put(b"BAD", "integrity:cov_hash-mismatch", peer="evil")  # dedup
    assert len(q) == 1
    (md5, rec), = q.load()
    assert md5 == md5_hex(b"BAD")
    assert rec["reason"] == "integrity:cov_hash-mismatch"
    assert rec["peer"] == "evil"


# -- peer bans ----------------------------------------------------------


def test_peer_bans_threshold_and_decorrelated_backoff():
    clock = [1000.0]
    bans = PeerBans(threshold=3, base_s=10.0, cap_s=100.0,
                    rng=random.Random(7), time_fn=lambda: clock[0])
    assert not bans.strike("evil")          # 1
    assert not bans.strike("evil")          # 2
    assert bans.strike("evil")              # 3 -> banned
    assert bans.is_banned("evil") and bans.total_bans == 1
    first_len = bans.banned_until["evil"] - clock[0]
    assert 10.0 <= first_len <= 100.0
    # ban expires with the clock
    clock[0] += first_len + 1
    assert not bans.is_banned("evil")
    # next ban draws from U[base, 3x previous] — the decorrelated
    # jitter discipline (can exceed base when prev was long)
    assert bans.strike("evil", n=3)
    second_len = bans.banned_until["evil"] - clock[0]
    assert 10.0 <= second_len <= min(100.0, 3.0 * first_len)
    # clean pulls forgive strikes
    bans2 = PeerBans(threshold=3, rng=random.Random(1))
    bans2.strike("flaky", 2)
    bans2.clean("flaky")
    assert not bans2.strike("flaky")        # count restarted


# -- chaos: partition mode + match scoping ------------------------------


def test_chaos_partition_mode_is_endpoint_scoped():
    import urllib.error
    eng = chaos.configure({"faults": [
        {"point": "manager_rpc", "mode": "partition", "every": 1,
         "match": "127.0.0.1:9999"}]})
    # unmatched endpoint: untouched
    chaos.chaos_point("manager_rpc", url="http://127.0.0.1:1234/api")
    with pytest.raises(urllib.error.URLError, match="partition"):
        chaos.chaos_point("manager_rpc",
                          url="http://127.0.0.1:9999/api/corpus/c")
    # match-scoped faults count their OWN hits (deterministic given
    # the matched request sequence alone)
    assert eng.faults[0].seen == 1
    chaos.configure(None)


def test_chaos_match_scoped_hit_counting():
    eng = chaos.configure({"faults": [
        {"point": "manager_rpc", "mode": "http500", "hit": 2,
         "match": "peerX"}]})
    chaos.chaos_point("manager_rpc", url="http://peerX/a")  # seen 1
    for _ in range(5):      # unmatched traffic must not advance it
        chaos.chaos_point("manager_rpc", url="http://other/a")
    import urllib.error
    with pytest.raises(urllib.error.HTTPError):
        chaos.chaos_point("manager_rpc", url="http://peerX/b")
    assert eng.faults[0].fired == 1
    chaos.configure(None)


# -- gossip sidecar + hub-free exchange --------------------------------


def _sim(tmp_path, name, url="http://127.0.0.1:1", **kw):
    return SimWorker(name, "g1", url, str(tmp_path), **kw)


def test_sidecar_cursor_api_and_boot_nonce(tmp_path):
    w = _sim(tmp_path, "w1")
    try:
        w.discover(3)
        side = w.sync.sidecar
        with urllib.request.urlopen(
                f"{side.endpoint}/api/corpus/g1?since=0") as r:
            body = json.loads(r.read())
        assert body["latest"] == 3 and len(body["entries"]) == 3
        assert body["boot"] == side.boot
        # cursor paging: since=2 -> only the third row
        with urllib.request.urlopen(
                f"{side.endpoint}/api/corpus/g1?since=2") as r:
            page = json.loads(r.read())
        assert [e["id"] for e in page["entries"]] == [3]
        # publish dedups by cov_hash
        e = w.store.load()[0]
        assert not side.publish(e)
        with urllib.request.urlopen(
                f"{side.endpoint}/api/ping") as r:
            ping = json.loads(r.read())
        assert ping["entries"] == 3 and ping["worker"] == "w1"
    finally:
        w.close()


def test_peer_exchange_flows_without_any_manager(tmp_path):
    """THE demotion gate: two workers whose manager never existed
    still exchange their corpus peer-to-peer — the hub is a phone
    book, not the data path."""
    w1 = _sim(tmp_path, "w1")
    w2 = _sim(tmp_path, "w2")
    try:
        w1.discover(2)
        w2.discover(1)
        # no directory (manager dead): inject peers as a cached list
        w1.sync.peers = {"w2": w2.sync.sidecar.endpoint}
        w2.sync.peers = {"w1": w1.sync.sidecar.endpoint}
        for _ in range(2):
            w1.round()
            w2.round()
        union = w1.cov_hashes() | w2.cov_hashes()
        assert len(union) == 3
        assert w1.cov_hashes() == union == w2.cov_hashes()
        # rounds FAILED at the manager (backoff engaged) yet gossip
        # flowed: partitioned-from-hub is visible but not fatal
        assert w1.sync.consecutive_failures > 0
        assert w1.registry.counters.get("gossip_entries_in", 0) >= 1
        assert w1.registry.counters.get("gossip_rounds", 0) >= 2
    finally:
        w1.close()
        w2.close()


def test_peer_cursor_survives_truncated_pages(tmp_path, monkeypatch):
    """The sidecar caps each GET at PAGE rows; the pull cursor must
    advance by the page actually RETURNED, not jump to `latest` —
    jumping would permanently skip the rows the truncated page did
    not carry (fatal with the hub down, when peers are the only
    source)."""
    monkeypatch.setattr(GossipSidecar, "PAGE", 2)
    w1 = _sim(tmp_path, "w1")
    w2 = _sim(tmp_path, "w2")
    try:
        w1.discover(5)
        w2.sync.peers = {"w1": w1.sync.sidecar.endpoint}
        want = w1.cov_hashes()
        for i, expect in enumerate((2, 4, 5)):
            w2.round()
            assert len(w2.cov_hashes() & want) == expect, \
                f"round {i}: cursor lost truncated-page rows"
    finally:
        w1.close()
        w2.close()


def test_peer_cursor_resets_on_peer_restart(tmp_path):
    """A restarted sidecar restarts its row ids; the boot nonce must
    make pullers re-pull from 0 — and the reset must not be clobbered
    by the same response's `latest`."""
    w1 = _sim(tmp_path, "w1")
    w2 = _sim(tmp_path, "w2")
    try:
        w1.discover(3)
        w2.sync.peers = {"w1": w1.sync.sidecar.endpoint}
        w2.round()
        assert len(w2.cov_hashes()) == 3
        assert w2.sync._peer_cursor["w1"][1] == 3
        # simulate the peer restarting with a fresh (shorter) log
        side = w1.sync.sidecar
        with side._lock:
            side.boot = "restarted"
            kept = side._rows[:2]
            for i, row in enumerate(kept):
                row["id"] = i + 1
            side._rows = kept
        w2.round()      # sees the boot change: resets, admits nothing
        assert w2.sync._peer_cursor["w1"] == ["restarted", 0]
        w2.round()      # re-pulls from 0 (dedup absorbs the overlap)
        assert w2.sync._peer_cursor["w1"][1] == 2
    finally:
        w1.close()
        w2.close()


def test_sidecar_serves_from_store_without_heap_copy(tmp_path):
    """With a store attached, sidecar rows hold METADATA only (no
    second in-heap copy of the corpus); content is read from disk at
    serve time and the wire shape is unchanged."""
    w1 = _sim(tmp_path, "w1")
    w2 = _sim(tmp_path, "w2")
    try:
        w1.discover(3)
        side = w1.sync.sidecar
        with side._lock:
            assert all("_buf" not in r and "content_b64" not in r
                       for r in side._rows)
        w2.sync.peers = {"w1": side.endpoint}
        w2.round()
        assert len(w2.cov_hashes()) == 3    # lazy reads served fine
    finally:
        w1.close()
        w2.close()


def test_peer_cursor_ignores_malformed_row_id(tmp_path):
    """One hostile row with a garbage id must not collapse the
    page's ids to [] and trigger the latest-jump fallback (which
    would skip the truncated backlog)."""
    w1 = _sim(tmp_path, "w1")
    w2 = _sim(tmp_path, "w2")
    try:
        w1.discover(2)
        side = w1.sync.sidecar
        with side._lock:
            side._rows[0]["id"] = "x"       # hostile id
        w2.sync.peers = {"w1": side.endpoint}
        w2.round()
        # the good row's id (2) advanced the cursor; no jump past it
        assert w2.sync._peer_cursor["w1"][1] == 2
    finally:
        w1.close()
        w2.close()


def test_db_consume_recovery_is_one_shot():
    db = ManagerDB()
    assert not db.consume_recovery()        # never degraded
    db.degraded = True
    db._exec("SELECT 1")                    # a successful write path
    assert db.degraded is False
    assert db.consume_recovery() is True
    assert db.consume_recovery() is False   # one-shot
    db.close()


def test_journal_note_committed_never_truncates(tmp_path):
    """Truncation outside replay() could destroy a journal-only-ACKed
    record another handler is still mid-flight on — note_committed
    only accounts; replay() (lock-held) is the only truncation."""
    from killerbeez_tpu_torch.manager.journal import AdmissionJournal
    j = AdmissionJournal(str(tmp_path / "j"), compact_bytes=1)
    j.append_corpus("c", "sig:x", "m", "w", b"DATA", None)
    j.note_committed()
    assert os.path.getsize(str(tmp_path / "j")) > 0   # kept
    assert j.needs_compact()
    db = ManagerDB()
    j.replay(db)                            # the safe compaction path
    assert os.path.getsize(str(tmp_path / "j")) == 0
    assert len(db.get_corpus_entries("c", 0)) == 1
    db.close()
    j.close()


def test_empty_directory_never_replaces_cached_peers(tmp_path):
    """A write-degraded manager freezes last_seen fleet-wide, so its
    directory can read empty while every peer is alive — the cached
    directory must survive, or gossip halts during exactly the
    outage it exists for."""
    s = ManagerServer(port=0)
    s.start()
    w = _sim(tmp_path, "w1", url=f"http://127.0.0.1:{s.port}")
    try:
        w.sync.peers = {"w9": "http://127.0.0.1:9"}
        w.sync._refresh_peers()     # directory empty server-side
        assert w.sync.peers == {"w9": "http://127.0.0.1:9"}
    finally:
        w.close()
        s.stop()


def test_peer_directory_ignores_liveness_while_degraded(tmp_path):
    """While DB writes fail, heartbeats can't refresh last_seen, so
    liveness classification is stale — the directory serves every
    registered endpoint instead of reading the fleet dead."""
    from killerbeez_tpu_torch.manager.fleet import (
        FleetConfig, peer_directory,
    )
    db = ManagerDB()
    db.note_fleet_worker("c", "w1", meta={"gossip": "http://a:1"},
                         now=1.0)      # ancient: classifies DEAD
    cfg = FleetConfig()
    assert peer_directory(db, cfg, "c") == []
    db.degraded = True
    peers = peer_directory(db, cfg, "c")
    assert [p["worker"] for p in peers] == ["w1"]
    db.close()


def test_poisoned_peer_is_quarantined_and_banned(tmp_path):
    """Acceptance: a poisoned entry is never admitted, never crashes
    the worker, lands in the quarantine dir, and the offending peer
    is banned after the threshold."""
    evil = _sim(tmp_path, "evil")
    good = _sim(tmp_path, "good", ban_threshold=3)
    try:
        forged = evil.poison(4)
        evil.discover(1)            # honest entry rides along
        good.sync.peers = {"evil": evil.sync.sidecar.endpoint}
        good.round()
        # honest entry admitted, forged ones never
        got = good.cov_hashes()
        assert not (set(forged) & got)
        assert len(got - {e.cov_hash
                          for e in good.store.load()
                          if e.source == "local"}) <= 1
        reg = good.registry
        assert reg.counters.get("sync_quarantined", 0) == 4
        assert reg.counters.get("peers_banned", 0) == 1
        assert good.sync.bans.is_banned("evil")
        # quarantine artifacts on disk for the operator
        q = QuarantineStore(good.store.root)
        assert len(q) == 4
        assert all(rec["peer"] == "evil" for _, rec in q.load())
        # banned peer is excluded from subsequent fanout picks
        before = reg.counters.get("gossip_entries_in", 0)
        good.round()
        assert reg.counters.get("sync_quarantined", 0) == 4
        assert reg.counters.get("gossip_entries_in", 0) == before
    finally:
        evil.close()
        good.close()


def test_fuzzer_loop_runs_with_gossip_sync(tmp_path):
    """Loop integration: the production Fuzzer accepts a GossipSync
    wherever it took a CorpusSync — admissions publish through the
    sidecar, a second campaign pulls them (hub or peers), and the
    gossip counters land in the registry the stats sink reads."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    from killerbeez_tpu_torch.instrumentation.factory import (
        instrumentation_factory,
    )
    from killerbeez_tpu_torch.mutators.factory import mutator_factory

    s = ManagerServer(port=0)
    s.start()
    url = f"http://127.0.0.1:{s.port}"

    def campaign(name, seed_n):
        instr = instrumentation_factory(
            "jit_harness",
            '{"target": "cgc_like", "novelty": "throughput"}',
            device="cpu")
        mut = mutator_factory("havoc", json.dumps({"seed": seed_n}),
                              b"CG\x02\x04\x05\x41xx", device="cpu")
        drv = driver_factory("file", None, instr, mut, device="cpu")
        sync = GossipSync(url, "loopg", worker=name,
                          interval_s=0.0)
        fz = Fuzzer(drv, output_dir=str(tmp_path / name),
                    batch_size=256, feedback=2,
                    corpus_dir=str(tmp_path / name / "c"), sync=sync)
        fz.PERSIST_INTERVAL = 0.0
        return fz

    try:
        f1 = campaign("g1", 11)
        f1.run(1024)
        assert f1.sync.pushed_n > 0
        f2 = campaign("g2", 22)
        f2.run(1024)
        assert f2.sync.pulled_n > 0
        assert "sync" in [a.source for a in f2.scheduler.arms]
        c = f2.telemetry.registry.counters
        assert c.get("gossip_rounds", 0) > 0
        # g2's sidecar serves everything it admitted or learned
        assert len(f2.sync.sidecar) >= f2.sync.pulled_n
    finally:
        f1.sync.close()
        f2.sync.close()
        s.stop()


# -- manager durability: WAL, locked retry, degraded mode, journal ------


def _post(url, path, payload):
    r = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as resp:
        return json.loads(resp.read())


def _corpus_post(buf, sig, worker="w1"):
    return {"worker": worker, "md5": md5_hex(buf),
            "cov_hash": coverage_hash(sig, buf),
            "content_b64": base64.b64encode(buf).decode(),
            "meta": {"sig": sig, "md5": md5_hex(buf),
                     "cov_hash": coverage_hash(sig, buf)}}


def test_file_backed_db_runs_wal_with_busy_timeout(tmp_path):
    db = ManagerDB(str(tmp_path / "m.db"))
    conn = db._conn()
    assert conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    assert conn.execute("PRAGMA busy_timeout").fetchone()[0] \
        == ManagerDB.BUSY_TIMEOUT_MS
    db.close()


def test_db_write_retries_database_is_locked(tmp_path):
    """A lock burst (concurrent heartbeats) must retry with bounded
    backoff instead of 500ing the POST — the sync's reject rule would
    otherwise drop that entry from sync forever."""
    import sqlite3
    db = ManagerDB(str(tmp_path / "m.db"))
    calls = {"n": 0}

    class FlakyConn:
        def execute(self, sql, params=()):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise sqlite3.OperationalError("database is locked")
            return db._conn().execute(sql, params)

        def rollback(self):
            pass

    cur = db._write(FlakyConn(), "SELECT 1")
    assert cur.fetchone()[0] == 1
    assert calls["n"] == 3 and not db.degraded
    # exhaustion: degraded latches and the typed error surfaces
    class AlwaysLocked:
        def execute(self, sql, params=()):
            raise sqlite3.OperationalError("database is locked")

        def rollback(self):
            pass

    with pytest.raises(ManagerWriteError):
        db._write(AlwaysLocked(), "SELECT 1")
    assert db.degraded
    db.close()


@pytest.fixture
def file_server(tmp_path):
    s = ManagerServer(port=0, db_path=str(tmp_path / "mgr.db"))
    s.start()
    yield s, f"http://127.0.0.1:{s.port}", str(tmp_path / "mgr.db")
    chaos.configure(None)
    s.stop()


def test_degraded_mode_keeps_serving_and_journal_acks(file_server):
    """ENOSPC on the corpus table: POSTs still ACK off the journal
    (201 + journaled flag — NOT the 4xx/5xx reject the worker would
    drop the entry over), cursor GETs keep serving, /api/health and
    /api/fleet read degraded, and recovery clears the latch."""
    s, url, _ = file_server
    assert _post(url, "/api/corpus/c1",
                 _corpus_post(b"ONE", [1]))[0] == 201
    chaos.configure({"faults": [
        {"point": "manager_db_write", "mode": "enospc", "every": 1,
         "match": "corpus_entries"}]})
    code, body = _post(url, "/api/corpus/c1",
                       _corpus_post(b"TWO", [2]))
    assert code == 201 and body["journaled"] and body["degraded"]
    # read-only: the cursor GET still serves what the DB has
    got = _get(url, "/api/corpus/c1?since=0")
    assert len(got["entries"]) == 1
    health = _get(url, "/api/health")
    assert health["degraded"] is True
    assert health["journal"]["uncommitted"] == 1
    assert _get(url, "/api/fleet")["degraded"] is True
    # events POST degrades identically
    chaos.configure({"faults": [
        {"point": "manager_db_write", "mode": "enospc", "every": 1,
         "match": "campaign_events"}]})
    code, body = _post(url, "/api/events/c1", {
        "worker": "w1",
        "events": [{"seq": 0, "t": 1.0, "type": "crash"}]})
    assert code == 201 and body["journaled"]
    # recovery: the next successful write clears the latch AND
    # replays the journal backlog in-process — the journal-only row
    # becomes visible to cursor GETs without any manager restart
    chaos.configure(None)
    assert _post(url, "/api/corpus/c1",
                 _corpus_post(b"THREE", [3]))[0] == 201
    assert _get(url, "/api/health")["degraded"] is False
    got = _get(url, "/api/corpus/c1?since=0")
    assert {e["md5"] for e in got["entries"]} == {
        md5_hex(b"ONE"), md5_hex(b"TWO"), md5_hex(b"THREE")}
    assert _get(url, "/api/health")["journal"]["uncommitted"] == 0


def test_journal_replays_acked_posts_after_manager_death(file_server,
                                                         tmp_path):
    """The SIGKILL-equivalence gate: rows ACKed journal-only while
    the DB was failing exist in the DB after a restart on the same
    paths — a killed manager loses ZERO accepted POSTs."""
    s, url, db_path = file_server
    _post(url, "/api/corpus/c2", _corpus_post(b"KEEP1", [1]))
    chaos.configure({"faults": [
        {"point": "manager_db_write", "mode": "enospc", "every": 1,
         "match": "corpus_entries"}]})
    _post(url, "/api/corpus/c2", _corpus_post(b"KEEP2", [2]))
    _post(url, "/api/events/c2", {
        "worker": "w1",
        "events": [{"seq": 0, "t": 1.0, "type": "crash",
                    "md5": "x"}]})
    chaos.configure(None)
    s.stop()        # the fixture's stop() later is a no-op double
    s2 = ManagerServer(port=0, db_path=db_path)
    try:
        rows = s2.db.get_corpus_entries("c2", 0)
        assert {r["md5"] for r in rows} \
            == {md5_hex(b"KEEP1"), md5_hex(b"KEEP2")}
        evs = s2.db.get_campaign_events("c2", 0)
        assert [e["event"]["seq"] for e in evs
                if e["worker"] == "w1"] == [0]
        # replay truncated the journal: a second boot replays nothing
        assert s2.journal.uncommitted == 0
        assert os.path.getsize(db_path + ".journal") == 0
    finally:
        s2.stop()


def test_peer_directory_registration_and_liveness(file_server):
    s, url, _ = file_server
    code, body = _post(url, "/api/peers/c3",
                       {"worker": "w1",
                        "endpoint": "http://127.0.0.1:7001"})
    assert code == 201 and body["peers"] == []   # self excluded
    _post(url, "/api/peers/c3", {"worker": "w2",
                                 "endpoint": "http://127.0.0.1:7002"})
    peers = _get(url, "/api/peers/c3")["peers"]
    assert {p["worker"]: p["endpoint"] for p in peers} == {
        "w1": "http://127.0.0.1:7001",
        "w2": "http://127.0.0.1:7002"}
    # a worker whose heartbeats stopped long ago drops out (DEAD)
    s.db.note_fleet_worker("c3", "w3", meta={"gossip": "http://x:1"},
                           now=1.0)
    names = {p["worker"] for p in _get(url, "/api/peers/c3")["peers"]}
    assert "w3" not in names and {"w1", "w2"} <= names
    # bad endpoints are refused
    with pytest.raises(urllib.error.HTTPError):
        _post(url, "/api/peers/c3", {"worker": "wX",
                                     "endpoint": "gopher://nope"})


def test_heartbeat_meta_merges_with_gossip_registration(file_server):
    """The gossip endpoint and the heartbeat's pid/host land in the
    same registry row without clobbering each other."""
    s, url, _ = file_server
    _post(url, "/api/peers/c4", {"worker": "w1",
                                 "endpoint": "http://127.0.0.1:7009"})
    _post(url, "/api/stats/c4", {
        "worker": "w1", "snapshot": {"counters": {"execs": 10}},
        "meta": {"pid": 123}})
    row, = s.db.get_fleet_workers("c4")
    assert row["meta"]["gossip"] == "http://127.0.0.1:7009"
    assert row["meta"]["pid"] == 123
    # directory still serves it after the heartbeat
    assert _get(url, "/api/peers/c4")["peers"][0]["endpoint"] \
        == "http://127.0.0.1:7009"


def test_fleet_view_surfaces_quarantine_and_ban_state(file_server):
    """kb-fleet --json reads workers.<w>.stats.sync_quarantined /
    peers_banned — the fleet-chaos CI lane asserts on these."""
    s, url, _ = file_server
    _post(url, "/api/stats/c5", {"worker": "w1", "snapshot": {
        "counters": {"execs": 100, "sync_quarantined": 7,
                     "peers_banned": 1, "gossip_entries_in": 42,
                     "gossip_entries_out": 17},
        "gauges": {"peers_banned_active": 1}}})
    body = _get(url, "/api/fleet/c5")
    stats = body["workers"]["w1"]["stats"]
    assert stats["sync_quarantined"] == 7
    assert stats["peers_banned"] == 1
    assert stats["peers_banned_active"] == 1
    assert stats["gossip_entries_in"] == 42
    assert stats["gossip_entries_out"] == 17
    # merged fleet counters fold them (aggregate.merge sums counters)
    assert body["merged"]["counters"]["sync_quarantined"] == 7
    # and /metrics exposes them through the parser-pinned surface
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    from tests.openmetrics_parser import parse_openmetrics
    families = parse_openmetrics(text)
    assert "kbz_sync_quarantined" in families
    assert "kbz_manager_degraded" in families
