"""Simulated fleet — the chaos convergence rig.

The chaos harness proves ONE campaign survives kills and torn
writes; this module proves the FLEET converges: tens to ~100
in-process workers, each with a real corpus store, a real
:class:`~killerbeez_tpu_torch.corpus.gossip.GossipSync` client (sidecar
HTTP server included) and a real event stream, exchanging corpus
entries through a real manager — while the test injects manager
SIGKILLs, scoped network partitions and poisoned entries between
rounds.

The workers are *simulated* only in that they do not run the fuzzing
loop: each mints deterministic synthetic edge-novel findings instead
(seeded per worker, unique coverage signatures), because the thing
under test is the EXCHANGE tier — admission, gossip, quarantine,
journal, convergence — not the mutator.  Everything from
``note_entry`` on down is the production path.

Convergence invariant (the fleet-chaos CI gate): after the faults
heal and enough rounds pass, every worker's admitted ``cov_hash``
set equals the fault-free control's union, the manager's corpus
table covers that union, and each worker's event stream is stored
gapless and duplicate-free — no finding and no event is lost to a
dead hub, a partition, or a poisoned peer.
"""

from __future__ import annotations

import base64
import os
import random
import time
from typing import Any, Dict, List, Optional, Set

from ..corpus.gossip import GossipSync
from ..corpus.quarantine import PeerBans
from ..corpus.schedule import Arm, make_scheduler
from ..corpus.store import CorpusEntry, CorpusStore
from ..telemetry import Telemetry
from ..utils.fileio import md5_hex
from ..utils.logging import DEBUG_MSG


class SimWorker:
    """One in-process fleet worker: real store + scheduler + gossip
    client + event queue, synthetic discoveries.

    Quacks like the ``Fuzzer`` where the sync client needs it
    (``telemetry``, ``scheduler``, ``store``, ``_seen``,
    ``feedback``) — the exchange tier cannot tell it from the real
    loop."""

    def __init__(self, name: str, campaign: str, manager_url: str,
                 root: str, fanout: int = 2, seed: int = 0,
                 ban_threshold: int = 3,
                 peer_refresh_rounds: int = 1):
        self.name = name
        self.campaign = str(campaign)
        self.manager_url = manager_url.rstrip("/")
        self.telemetry = Telemetry(None)
        self.scheduler = make_scheduler("rr")
        self.scheduler.base_seed = b"SIM"
        self.store = CorpusStore(os.path.join(root, name))
        self._seen: Dict[str, Set[str]] = {"new_paths": set()}
        self.feedback = 1
        self.rng = random.Random(hash((seed, name)) & 0x7FFFFFFF)
        self.sync = GossipSync(
            manager_url, campaign, worker=name, interval_s=0.0,
            attempts=1, rng=self.rng, fanout=fanout,
            # sim rounds are fast and scripted: refresh the directory
            # every round while the hub answers (failures keep the
            # cache — that IS the partition-tolerance under test)
            peer_refresh_rounds=peer_refresh_rounds,
            bans=PeerBans(threshold=ban_threshold, base_s=30.0,
                          rng=self.rng))
        self.sync.sidecar.attach_store(self.store)
        self._find_n = 0
        self._poison_n = 0
        #: worker-minted event records awaiting a successful POST to
        #: the manager (monotone seq; re-sends are dedup-safe)
        self._event_seq = 0
        self._events_pending: List[Dict[str, Any]] = []
        self.events_acked = 0

    # -- synthetic discovery -------------------------------------------

    def discover(self, n: int = 1) -> List[CorpusEntry]:
        """Mint ``n`` deterministic edge-novel findings and run them
        through the production admission path (store write-through,
        sync note, scheduler admission, event record)."""
        out = []
        for _ in range(int(n)):
            i = self._find_n
            self._find_n += 1
            buf = f"{self.name}:find:{i}".encode()
            # unique, deterministic coverage: no two synthetic
            # findings (across the whole fleet) share a cov_hash
            base = int.from_bytes(
                md5_hex(buf)[:8].encode(), "big") % 1000003
            sig = sorted({base, 1000100 + i * 131 + len(self.name)})
            entry = CorpusEntry(buf, seq=self.store.next_seq(),
                                sig=sig, parent="base",
                                source="local")
            self.store.put(entry)
            self._seen["new_paths"].add(entry.md5)
            self.scheduler.admit(Arm.from_entry(entry))
            self.sync.note_entry(entry)
            self._queue_event("new_path", md5=entry.md5,
                              cov_hash=entry.cov_hash)
            out.append(entry)
        return out

    def poison(self, n: int = 1) -> List[str]:
        """EVIL MODE: publish ``n`` forged rows straight into this
        worker's sidecar — valid bytes, FORGED cov_hash — bypassing
        every honest path.  Returns the forged hashes so the test can
        assert none was ever admitted anywhere."""
        forged = []
        with self.sync.sidecar._lock:
            for _ in range(int(n)):
                # own counter: poisoning must not shift the honest
                # discovery sequence (the control run never poisons,
                # and the convergence gate compares unions exactly)
                i = self._poison_n
                self._poison_n += 1
                buf = f"{self.name}:poison:{i}".encode()
                fake = f"sig:{md5_hex(buf)}"     # never re-derivable
                forged.append(fake)
                self.sync.sidecar._rows.append({
                    "id": len(self.sync.sidecar._rows) + 1,
                    "md5": md5_hex(buf),
                    "cov_hash": fake,
                    "worker": self.name,
                    "content_b64":
                        base64.b64encode(buf).decode(),
                    "meta": {"sig": [1], "cov_hash": fake,
                             "md5": md5_hex(buf)},
                })
        return forged

    # -- event stream ---------------------------------------------------

    def _queue_event(self, etype: str, **fields) -> None:
        rec = {"v": 1, "seq": self._event_seq, "t": time.time(),
               "type": etype}
        rec.update(fields)
        self._event_seq += 1
        self._events_pending.append(rec)

    def flush_events(self) -> bool:
        """POST pending events (through the manager_rpc chaos seam);
        pending survives failure and re-sends are dedup-safe."""
        if not self._events_pending:
            return True
        from ..manager.worker import _request_retry
        try:
            _request_retry(
                f"{self.manager_url}/api/events/{self.campaign}",
                {"worker": self.name,
                 "events": self._events_pending},
                attempts=1)
        except Exception as e:
            DEBUG_MSG("simworker %s event flush failed: %s",
                      self.name, e)
            return False
        self.events_acked += len(self._events_pending)
        self._events_pending = []
        return True

    # -- rounds / state -------------------------------------------------

    def round(self) -> None:
        """One exchange round: manager anti-entropy + peer gossip
        (the production ``maybe_sync``) then the event flush."""
        self.sync.maybe_sync(self, force=True)
        self.flush_events()

    def cov_hashes(self) -> Set[str]:
        """Every admitted cov_hash in this worker's durable store."""
        return {e.cov_hash for e in self.store.load()}

    @property
    def registry(self):
        return self.telemetry.registry

    def close(self) -> None:
        self.sync.close()


class SimFleet:
    """N workers on one campaign, driven round by round."""

    def __init__(self, n_workers: int, campaign: str,
                 manager_url: str, root: str, fanout: int = 2,
                 seed: int = 0, ban_threshold: int = 3,
                 peer_refresh_rounds: int = 1):
        self.campaign = str(campaign)
        self.workers: List[SimWorker] = [
            SimWorker(f"w{i:03d}", campaign, manager_url,
                      root, fanout=fanout, seed=seed + i,
                      ban_threshold=ban_threshold,
                      peer_refresh_rounds=peer_refresh_rounds)
            for i in range(int(n_workers))]

    def round(self, discoveries: int = 0,
              skip: Optional[Set[int]] = None) -> None:
        """One fleet round: each worker (minus ``skip``) mints
        ``discoveries`` findings then exchanges."""
        for i, w in enumerate(self.workers):
            if skip and i in skip:
                continue
            if discoveries:
                w.discover(discoveries)
            w.round()

    def rounds_until_converged(self, target: Set[str],
                               max_rounds: int = 64) -> int:
        """Exchange-only rounds until every worker's store holds
        ``target``; returns rounds used (== max_rounds means it never
        converged — the caller's assert then prints the holdouts)."""
        for r in range(int(max_rounds)):
            if all(target <= w.cov_hashes() for w in self.workers):
                return r
            self.round()
        return int(max_rounds)

    def union(self) -> Set[str]:
        out: Set[str] = set()
        for w in self.workers:
            out |= w.cov_hashes()
        return out

    def close(self) -> None:
        for w in self.workers:
            w.close()
