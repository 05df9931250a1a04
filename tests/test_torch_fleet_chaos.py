"""The port's partition-tolerant fleet tier, part 2 (the counterpart of
tests/test_fleet_chaos.py on the CPU): sync pull-path failures
under chaos, and THE fleet chaos convergence gates — a simulated
fleet (resilience/fleetsim.py) of in-process gossiping workers
surviving a manager death, a scoped >= 2-round network partition and
a poisoned peer, converging to the fault-free control: identical
union of admitted cov_hashes, zero lost findings, per-worker event
streams stored gapless, the poison quarantined and its peer banned.

The >= 32-worker SIGKILL gate is slow-marked (the fleet-chaos CI
lane runs it); a 6-worker in-process version guards tier-1.
KBZ_FLEET_N scales the gate up (the harness drives ~100 workers)."""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from killerbeez_tpu_torch.corpus import CorpusStore, CorpusSync
from killerbeez_tpu_torch.corpus.schedule import make_scheduler
from killerbeez_tpu_torch.corpus.store import CorpusEntry
from killerbeez_tpu_torch.manager.api import ManagerServer
from killerbeez_tpu_torch.resilience import chaos
from killerbeez_tpu_torch.resilience.fleetsim import SimFleet
from killerbeez_tpu_torch.telemetry import Telemetry


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    chaos.configure(None)


# -- corpus/sync.py pull-path failures under chaos ----------------------


class _Fz:
    """Minimal fuzzer protocol for CorpusSync (telemetry, scheduler,
    store, _seen, feedback) — the sync client can't tell it from the
    loop."""

    def __init__(self, root=None):
        self.telemetry = Telemetry(None)
        self.scheduler = make_scheduler("rr")
        self.scheduler.base_seed = b"S"
        self.store = CorpusStore(root) if root else None
        self._seen = {"new_paths": set()}
        self.feedback = 1


@pytest.fixture
def server(tmp_path):
    s = ManagerServer(port=0, db_path=str(tmp_path / "m.db"))
    s.start()
    yield s, f"http://127.0.0.1:{s.port}"
    chaos.configure(None)
    s.stop()


@pytest.mark.parametrize("mode", ["http500", "timeout", "partition"])
def test_pull_path_failure_backs_off_decorrelated(server, tmp_path,
                                                  mode):
    """Satellite gate: chaos-injected pull failures engage the
    decorrelated round backoff, raise sync_consecutive_failures, and
    a recovered endpoint resets both."""
    s, url = server
    sync = CorpusSync(url, "cs1", worker="puller", interval_s=2.0,
                      attempts=1)
    fz = _Fz(str(tmp_path / "p"))
    assert sync.maybe_sync(fz, force=True)      # healthy baseline
    assert sync.consecutive_failures == 0 and sync._backoff == 0.0
    spec = {"point": "manager_rpc", "mode": mode, "every": 1}
    if mode == "partition":
        spec["match"] = f":{s.port}"            # endpoint-scoped
    chaos.configure({"faults": [spec]})
    backoffs = []
    for i in range(1, 4):
        assert sync.maybe_sync(fz, force=True)
        assert sync.consecutive_failures == i
        assert fz.telemetry.registry.gauges[
            "sync_consecutive_failures"] == i
        backoffs.append(sync._backoff)
    # decorrelated jitter: every failed round's extra delay is drawn
    # from U[interval, 3x previous], never below the interval and
    # never above the cap
    assert all(sync.interval_s <= b <= sync.backoff_cap
               for b in backoffs)
    assert backoffs[-1] <= 3.0 * max(backoffs[:-1]) + 1e-9
    chaos.configure(None)
    assert sync.maybe_sync(fz, force=True)
    assert sync.consecutive_failures == 0 and sync._backoff == 0.0


@pytest.mark.parametrize("mode", ["timeout", "partition"])
def test_recovered_endpoint_drains_requeue_without_dup_arms(
        server, tmp_path, mode):
    """Entries admitted during a partition requeue (never drop), the
    recovered manager receives each exactly once, and the puller
    admits each exactly once — no duplicate arm is ever minted."""
    s, url = server
    pusher = CorpusSync(url, "cs2", worker="pusher", interval_s=0.0,
                        attempts=1)
    fz = _Fz(str(tmp_path / "push"))
    chaos.configure({"faults": [
        {"point": "manager_rpc", "mode": mode, "every": 1}]})
    entries = [CorpusEntry(f"E{i}".encode(), sig=[100 + i])
               for i in range(4)]
    for e in entries[:2]:
        pusher.note_entry(e)
    assert pusher.maybe_sync(fz, force=True)    # fails, requeues
    for e in entries[2:]:
        pusher.note_entry(e)
    assert pusher.maybe_sync(fz, force=True)
    assert pusher.pushed_n == 0
    assert len(pusher._pending) == 4            # requeued, not lost
    chaos.configure(None)
    assert pusher.maybe_sync(fz, force=True)    # drains
    assert pusher.pushed_n == 4
    rows = s.db.get_corpus_entries("cs2", 0)
    assert len(rows) == 4
    # the puller side: admits each exactly once across two rounds
    puller = CorpusSync(url, "cs2", worker="puller", interval_s=0.0,
                        attempts=1)
    fz2 = _Fz(str(tmp_path / "pull"))
    puller.maybe_sync(fz2, force=True)
    assert puller.pulled_n == 4
    arms = [a.md5 for a in fz2.scheduler.arms]
    assert len(arms) == len(set(arms)) == 4
    puller.maybe_sync(fz2, force=True)          # idempotent
    assert puller.pulled_n == 4
    assert len(fz2.scheduler.arms) == 4


# -- the convergence harness -------------------------------------------


def _manager_cov_hashes(url, campaign):
    with urllib.request.urlopen(
            f"{url}/api/corpus/{campaign}?since=0", timeout=10) as r:
        body = json.loads(r.read())
    return {e["cov_hash"] for e in body["entries"]}


def _assert_event_streams_gapless(url, campaign, fleet):
    """Every worker's stored event seqs are 0..n-1, no gaps, no
    duplicates — nothing lost to the kill or the partition, nothing
    double-stored by the re-sends."""
    with urllib.request.urlopen(
            f"{url}/api/events/{campaign}?since=0", timeout=10) as r:
        body = json.loads(r.read())
    by_worker = {}
    for row in body["events"]:
        by_worker.setdefault(row["worker"], []).append(
            row["event"]["seq"])
    for w in fleet.workers:
        seqs = sorted(by_worker.get(w.name, []))
        assert seqs == list(range(w._event_seq)), \
            f"{w.name}: stored seqs {seqs} vs minted {w._event_seq}"


def _control_union(tmp_path, n, plan, seed):
    """The fault-free control: same worker names/seeds/discovery
    plan, healthy manager throughout.  Returns its converged union —
    the set every faulted run must reproduce exactly."""
    s = ManagerServer(port=0,
                      db_path=str(tmp_path / "control.db"))
    s.start()
    url = f"http://127.0.0.1:{s.port}"
    fleet = SimFleet(n, "ctl", url, str(tmp_path / "control"),
                     seed=seed)
    try:
        for find_n in plan:
            fleet.round(discoveries=find_n)
        target = fleet.union()
        assert fleet.rounds_until_converged(target, 32) < 32
        assert all(w.cov_hashes() == target for w in fleet.workers)
        _assert_event_streams_gapless(url, "ctl", fleet)
        return target
    finally:
        fleet.close()
        s.stop()


def test_fleet_converges_through_manager_death_small(tmp_path):
    """Tier-1 guard (6 workers, in-process manager): the hub dies
    mid-campaign, discoveries keep spreading peer-to-peer while it
    is down, and after a restart on the same db+journal the fleet
    AND the manager converge to the fault-free control."""
    n, plan, seed = 6, (2, 1, 1), 11
    control = _control_union(tmp_path, n, plan, seed)

    db = str(tmp_path / "mgr.db")
    s = ManagerServer(port=0, db_path=db)
    s.start()
    port = s.port
    url = f"http://127.0.0.1:{port}"
    fleet = SimFleet(n, "cmp", url, str(tmp_path / "fleet"),
                     seed=seed)
    try:
        fleet.round(discoveries=plan[0])    # healthy: register+seed
        fleet.round()                       # directories complete
        s.stop()                            # the hub dies
        chaos.configure({"faults": [
            {"point": "manager_rpc", "mode": "partition",
             "every": 1, "match": f":{port}"}]})
        # hub-dead rounds: NEW discoveries still reach every peer
        # (epidemic pull with fanout 2 — a straggler can need a few
        # extra rounds, all of them hub-dead)
        fleet.round(discoveries=plan[1])
        fleet.round(discoveries=plan[2])
        dead_rounds = fleet.rounds_until_converged(fleet.union(), 8)
        assert dead_rounds < 8, \
            "gossip did not converge while the hub was dead"
        # restart on the same db (+ journal) and heal the partition
        chaos.configure(None)
        s2 = ManagerServer(port=port, db_path=db)
        s2.start()
        try:
            assert fleet.rounds_until_converged(control, 16) < 16
            assert all(w.cov_hashes() == control
                       for w in fleet.workers)
            # anti-entropy: the requeued pushes catch the manager up
            # within a bounded number of healthy rounds — no finding
            # lost to the death window
            for _ in range(8):
                if _manager_cov_hashes(url, "cmp") >= control:
                    break
                fleet.round()
            assert _manager_cov_hashes(url, "cmp") == control
            _assert_event_streams_gapless(url, "cmp", fleet)
        finally:
            s2.stop()
    finally:
        fleet.close()
        chaos.configure(None)


# -- THE acceptance gate: >= 32 workers, SIGKILL, partition, poison -----


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_manager(port, db, journal, timeout=30.0):
    proc = subprocess.Popen(
        [sys.executable, "-m", "killerbeez_tpu_torch.manager",
         "--port", str(port), "--db", db, "--journal", journal],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/api/health",
                                        timeout=2) as r:
                if json.loads(r.read()).get("ok"):
                    return proc
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"manager died at boot (rc {proc.returncode})")
            time.sleep(0.1)
    proc.kill()
    raise RuntimeError("manager never became healthy")


@pytest.mark.slow
def test_fleet_chaos_convergence_gate(tmp_path):
    """The acceptance gate: a >= 32-worker simulated fleet
    takes a manager SIGKILL mid-campaign plus a >= 2-round scoped
    partition (one worker's sidecar severed) plus a poisoned peer,
    and still converges to the fault-free control — identical
    cov_hash union everywhere, the restarted manager's table covers
    it (journal + anti-entropy), every event stream gapless, the
    poison never admitted and its source banned."""
    n = int(os.environ.get("KBZ_FLEET_N", "32"))
    plan, seed = (2, 1), 23
    control = _control_union(tmp_path, n, plan, seed)

    port = _free_port()
    db = str(tmp_path / "gate.db")
    journal = db + ".journal"
    proc = _spawn_manager(port, db, journal)
    url = f"http://127.0.0.1:{port}"
    fleet = SimFleet(n, "gate", url, str(tmp_path / "gate"),
                     seed=seed)
    evil = fleet.workers[-1]
    try:
        fleet.round(discoveries=plan[0])    # healthy rounds: the
        fleet.round()                       # directory completes
        forged = evil.poison(4)             # the poisoned peer

        # the power cut: SIGKILL, not a clean stop — the journal is
        # what guarantees the ACKed admissions survive
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)

        # >= 2 hub-dead rounds, with one worker's sidecar ALSO
        # partitioned (scoped: only its endpoint is severed)
        cut = fleet.workers[0].sync.sidecar
        chaos.configure({"faults": [
            {"point": "manager_rpc", "mode": "partition",
             "every": 1, "match": f":{port}"},
            {"point": "gossip_serve", "mode": "partition",
             "every": 1, "match": f":{cut.port}"},
        ]})
        fleet.round(discoveries=plan[1])
        fleet.round()

        # heal everything; restart the manager on the same db+journal
        chaos.configure(None)
        proc = _spawn_manager(port, db, journal)

        rounds = fleet.rounds_until_converged(control, 32)
        assert rounds < 32, "fleet never converged to the control"
        assert all(w.cov_hashes() == control for w in fleet.workers)
        # no finding lost: the restarted manager covers the union
        for _ in range(8):
            if _manager_cov_hashes(url, "gate") >= control:
                break
            fleet.round()
        assert _manager_cov_hashes(url, "gate") == control
        _assert_event_streams_gapless(url, "gate", fleet)

        # the poison: never admitted ANYWHERE, quarantined, banned
        assert not (set(forged) & control)
        for w in fleet.workers:
            assert not (set(forged) & w.cov_hashes())
        assert not (set(forged) & _manager_cov_hashes(url, "gate"))
        quarantined = sum(
            w.registry.counters.get("sync_quarantined", 0)
            for w in fleet.workers)
        banned = sum(w.registry.counters.get("peers_banned", 0)
                     for w in fleet.workers)
        assert quarantined >= 4, "no worker quarantined the poison"
        assert banned >= 1, "nobody banned the poisoned peer"
        assert any(w.sync.bans.total_bans
                   and "w%03d" % (n - 1) in w.sync.bans._prev_ban
                   for w in fleet.workers if w is not evil)

        # kb-fleet's scripting surface sees the quarantine state the
        # CI lane asserts on (counters ride worker heartbeats; here
        # we post one snapshot the way the heartbeat thread would)
        victim = next(w for w in fleet.workers
                      if w.registry.counters.get("sync_quarantined"))
        body = json.dumps({
            "worker": victim.name,
            "snapshot": victim.telemetry.snapshot()}).encode()
        req = urllib.request.Request(
            url + "/api/stats/gate", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10)
        with urllib.request.urlopen(url + "/api/fleet/gate",
                                    timeout=10) as r:
            view = json.loads(r.read())
        stats = view["workers"][victim.name]["stats"]
        assert stats["sync_quarantined"] >= 4
        assert stats["peers_banned"] >= 1
    finally:
        fleet.close()
        chaos.configure(None)
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
