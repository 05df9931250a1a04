"""Manager-mediated corpus exchange — fleet workers share findings.

The reference's fleet shares coverage only through operators running
the merger tool between campaigns; here workers exchange the corpus
itself while running: every edge-novel entry is POSTed to the
manager's ``/api/corpus/<campaign>`` (deduped server-side by coverage
hash), and each worker periodically pulls peers' entries into its
local store and rotation — one worker's frontier becomes every
worker's next seed.

Transport discipline adapts the stats heartbeats' to an IN-LOOP
caller: HTTP-level rejections fail fast per entry (the manager saw
the request — retrying is a poison pill), transport errors abort the
ROUND, and — because ``maybe_sync()`` runs on the fuzzing-loop
thread, not a heartbeat thread — the in-loop default is a single
attempt per request (``attempts=1``): the interval gate already
retries at round granularity, so a dead manager costs one failed
connection per round instead of inline backoff sleeps.  Failed
rounds widen the gate with DECORRELATED jitter (next extra delay
drawn from U[interval, 3x previous], capped) so a recovering manager
is not hit by the whole fleet in interval-lockstep, and the
``sync_consecutive_failures`` gauge tells kb-fleet's stall alert
"partitioned" apart from "plateaued".  Everything degrades to
warnings — corpus sync must never stall or kill the fuzzing loop.

Every PULLED row passes the poisoned-entry quarantine
(``quarantine.EntryValidator``) before admission: schema and size
caps, ``cov_hash`` recomputed and compared, optional re-execution.
Failures land in ``<corpus>/quarantine/`` and the
``sync_quarantined`` counter — a corrupt manager row (or, on the
gossip path, a lying peer) can never crash a worker or poison its
rotation.  ``gossip.GossipSync`` extends this client with the
peer-to-peer exchange tier.
"""

from __future__ import annotations

import base64
import contextlib
import random
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ..utils.logging import DEBUG_MSG, WARNING_MSG
from .quarantine import EntryValidator, QuarantineStore
from .schedule import Arm
from .store import CorpusEntry


class CorpusSync:
    """One campaign's exchange client: push local edge-novel entries,
    pull peers' entries into the local store + scheduler."""

    def __init__(self, manager_url: str, campaign: str,
                 worker: str = "anon", interval_s: float = 30.0,
                 attempts: int = 1, backoff_cap: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 validator: Optional[EntryValidator] = None):
        self.url = f"{manager_url.rstrip('/')}/api/corpus/{campaign}"
        self.manager_url = manager_url.rstrip("/")
        self.campaign = str(campaign)
        self.worker = worker
        #: poisoned-entry gate on every pulled row (default on;
        #: ``validator=False`` disables — raw-transport tests only)
        if validator is None:
            validator = EntryValidator()
        self.validator = validator or None
        #: rejected rows from the LAST pull: [(buf|None, reason,
        #: peer|None)] — the sync round writes them to quarantine +
        #: counters and strikes the offending peer
        self._quarantined_round: List[
            Tuple[Optional[bytes], str, Optional[str]]] = []
        self.quarantined_n = 0
        self.interval_s = float(interval_s)
        self.attempts = int(attempts)
        self._last_sync = 0.0
        # round backoff after transport failures: DECORRELATED jitter
        # (next extra delay ~ U[interval, 3*previous], capped) — a
        # whole fleet whose manager just recovered must NOT retry in
        # interval-lockstep, which is exactly what a deterministic
        # backoff would produce across workers started together
        self.backoff_cap = (float(backoff_cap) if backoff_cap
                            else 16.0 * self.interval_s)
        self._backoff = 0.0              # extra delay beyond interval
        self._rng = rng or random.Random()
        #: consecutive failed rounds — surfaced as the
        #: ``sync_consecutive_failures`` gauge so kb-fleet's
        #: coverage-stall alert can tell "plateaued" from
        #: "partitioned"
        self.consecutive_failures = 0
        self._pushed: Set[str] = set()      # cov_hashes sent (or known)
        self._pending: List[CorpusEntry] = []   # admitted, not yet sent
        self._store_scanned = False
        self._cursor = 0                     # server-side id high-water
        self.pushed_n = 0
        self.pulled_n = 0

    def note_entry(self, entry: CorpusEntry) -> None:
        """The loop hands every admitted entry here at triage time;
        the next sync round pushes it.  O(1) — no store rescans."""
        self._pending.append(entry)

    def close(self) -> None:
        """Release any transport resources (the gossip subclass shuts
        its sidecar down here); the manager-only client holds none."""

    # -- transport (heartbeat discipline) -------------------------------

    def _request(self, payload: Optional[Dict[str, Any]] = None,
                 method: str = "POST",
                 query: str = "") -> Any:
        from ..manager.worker import _request_retry
        return _request_retry(self.url + query, payload, method,
                              attempts=self.attempts)

    # -- push -----------------------------------------------------------

    def push_entry(self, entry: CorpusEntry) -> Optional[bool]:
        """POST one entry; True when the manager stored it as new,
        False when it was a coverage-hash duplicate or the manager
        REJECTED it (HTTP error: the request arrived and was refused
        — retrying the same entry forever would poison every future
        round), None on transport failure (the caller aborts the
        round — one failed request must not become one backoff cycle
        PER entry)."""
        import urllib.error
        if entry.cov_hash in self._pushed:
            return False
        try:
            resp = self._request({
                "worker": self.worker,
                "md5": entry.md5,
                "cov_hash": entry.cov_hash,
                "content_b64": base64.b64encode(entry.buf).decode(),
                "meta": entry.meta_dict(),
            })
        except urllib.error.HTTPError as e:
            if getattr(e, "code", None) == 503:
                # write-degraded manager: "try again later", NOT a
                # rejection — dropping the entry here would lose it
                # from sync forever once the manager recovers
                WARNING_MSG("corpus push to %s deferred (manager "
                            "degraded): %s", self.url, e)
                return None
            WARNING_MSG("corpus push rejected by %s (%s): dropping "
                        "entry %s from sync", self.url, e, entry.md5)
            self._pushed.add(entry.cov_hash)    # never retried
            return False
        except Exception as e:
            WARNING_MSG("corpus push to %s failed: %s", self.url, e)
            return None
        self._pushed.add(entry.cov_hash)
        if resp and resp.get("new"):
            self.pushed_n += 1
            return True
        return False

    # -- pull -----------------------------------------------------------

    def _entries_from_rows(self, rows: Any,
                           peer: Optional[str] = None
                           ) -> List[CorpusEntry]:
        """Exchange rows -> validated, locally-unseen entries.  Rows
        the validator rejects go to ``_quarantined_round`` (the sync
        round writes them to the quarantine store, bumps counters and
        strikes the peer) instead of ever reaching admission."""
        out: List[CorpusEntry] = []
        if not isinstance(rows, list):
            self._quarantined_round.append(
                (None, "schema:entries-not-a-list", peer))
            return out
        for row in rows:
            cov = row.get("cov_hash", "") \
                if isinstance(row, dict) else ""
            if cov and cov in self._pushed:
                continue                 # already have this frontier
            if self.validator is not None:
                entry, reason = self.validator.validate(row)
                if entry is None:
                    buf = None
                    if isinstance(row, dict) and \
                            isinstance(row.get("content_b64"), str):
                        try:
                            buf = base64.b64decode(
                                row["content_b64"][: (8 << 20)])
                        except Exception:
                            buf = None
                    self._quarantined_round.append((buf, reason, peer))
                    continue
            else:
                try:
                    buf = base64.b64decode(row["content_b64"])
                except (KeyError, TypeError, ValueError):
                    continue
                meta = dict(row.get("meta") or {})
                meta.setdefault("md5", row.get("md5"))
                entry = CorpusEntry.from_meta(buf, meta)
            entry.source = "sync"
            # NOT added to _pushed here: only an ADMITTED foreign
            # entry is excluded from pushing (_admit_entries).  An
            # entry we authored ourselves can gossip back to us
            # before we ever reached the manager (hub down, peers
            # re-serving what they learned) — marking it known here
            # would mean NOBODY ever pushes it and the recovered
            # manager misses it forever.
            out.append(entry)
        return out

    def pull(self) -> Optional[List[CorpusEntry]]:
        """GET peers' entries newer than the cursor; returns the new
        (locally unseen, not self-authored, validator-clean) ones —
        None on transport failure (the round counts as failed and
        backs off)."""
        from urllib.parse import quote
        try:
            resp = self._request(
                None, method="GET",
                query=f"?since={self._cursor}"
                      f"&exclude={quote(self.worker, safe='')}")
        except Exception as e:
            WARNING_MSG("corpus pull from %s failed: %s", self.url, e)
            return None
        if not resp:
            return []
        try:
            self._cursor = max(self._cursor,
                               int(resp.get("latest", 0)))
        except (TypeError, ValueError):
            pass                         # hostile latest: keep cursor
        return self._entries_from_rows(resp.get("entries", []))

    # -- loop hook ------------------------------------------------------

    def maybe_sync(self, fuzzer, force: bool = False) -> bool:
        """Called by the loop between batches: when the interval has
        elapsed, push unsynced local arms/store entries and fold
        peers' entries into the local store, scheduler and dedup set.
        ``force`` skips the interval gate — the loop forces one round
        after its end-of-run drain, so findings triaged after the
        last in-loop sync (short campaigns triage EVERYTHING in the
        drain) still reach the fleet.  Returns True when a sync round
        ran."""
        now = time.time()
        gate = self.interval_s + self._backoff
        if not force and now - self._last_sync < gate:
            return False
        self._last_sync = now
        # flight recorder: the round gets its own trace lane (a slow
        # round shows up as host time stolen from the pipeline) and a
        # sync_round event carrying the per-round deltas
        tr = fuzzer.telemetry.trace
        with (tr.span("sync_round", lane="sync") if tr is not None
              else contextlib.nullcontext()):
            return self._sync_round(fuzzer)

    def _sync_round(self, fuzzer) -> bool:
        reg = fuzzer.telemetry.registry
        # push set: entries the loop admitted since the last round
        # (note_entry, O(1)) plus — ONCE, for resumed campaigns — the
        # pre-existing store and rotation arms; never a per-round
        # store rescan
        batch: List[CorpusEntry] = self._pending
        self._pending = []
        if not self._store_scanned:
            self._store_scanned = True
            batch = batch + [a.to_entry()
                             for a in fuzzer.scheduler.arms]
            if fuzzer.store is not None:
                batch = batch + fuzzer.store.load()
        sent = 0
        failed = False
        seen_local: Set[str] = set()
        for i, e in enumerate(batch):
            if e.source == "sync":
                # a previously-PULLED entry (resume): known frontier —
                # never pushed back, and the pull loop must not
                # re-admit it after a restart resets the cursor
                self._pushed.add(e.cov_hash)
                continue
            if e.cov_hash in seen_local or e.cov_hash in self._pushed:
                continue
            seen_local.add(e.cov_hash)
            ok = self.push_entry(e)
            if ok is None:
                # transport down: requeue the remainder and bail —
                # one backoff cycle per ROUND, not per entry
                self._pending = [x for x in batch[i:]
                                 if x.cov_hash not in self._pushed] \
                    + self._pending
                failed = True
                break
            sent += int(ok)
        # pull: peers' frontier into store + rotation
        pulled = 0
        if not failed:
            got = self.pull()
            if got is None:
                failed = True
                got = []
            pulled = self._admit_entries(fuzzer, got)
        # the gossip tier (peer fanout pulls) rides the same round;
        # its transport failures back off PEERS, never the round
        self._peer_round(fuzzer, reg)
        self._flush_quarantine(fuzzer, reg)
        # per-round deltas: restored cumulative counters (--resume)
        # keep counting up instead of snapping to process-local totals
        if sent:
            reg.count("corpus_synced_out", sent)
        if pulled:
            reg.count("corpus_synced_in", pulled)
        if failed:
            self.consecutive_failures += 1
            self._backoff = min(
                self.backoff_cap,
                self._rng.uniform(self.interval_s,
                                  max(self.interval_s,
                                      3.0 * self._backoff)))
            DEBUG_MSG("corpus sync: round failed (%d in a row); "
                      "next round in ~%.1fs",
                      self.consecutive_failures,
                      self.interval_s + self._backoff)
        else:
            self.consecutive_failures = 0
            self._backoff = 0.0
        reg.gauge("sync_consecutive_failures",
                  self.consecutive_failures)
        reg.gauge("corpus_arms", len(fuzzer.scheduler.arms))
        fuzzer.telemetry.event(
            "sync_round", pushed=int(sent), pulled=int(pulled),
            transport_failed=bool(failed))
        return True

    # -- shared admission / quarantine plumbing -------------------------

    def _admit_entries(self, fuzzer, entries: List[CorpusEntry]) -> int:
        """Fold validated pulled entries into the local store,
        dedup set and rotation; returns how many were new here."""
        admitted = 0
        for e in entries:
            if e.md5 in fuzzer._seen["new_paths"]:
                continue            # already local (e.g. post-resume)
            self._pushed.add(e.cov_hash)    # foreign: never push back
            admitted += 1
            self.pulled_n += 1
            if fuzzer.store is not None:
                e.seq = fuzzer.store.next_seq()
                fuzzer.store.put(e)
            # a pulled entry is a known path now: don't re-record
            # it as a local finding if this worker reproduces it
            fuzzer._seen["new_paths"].add(e.md5)
            if fuzzer.feedback:
                fuzzer.scheduler.admit(Arm.from_entry(e))
            DEBUG_MSG("corpus sync: pulled %s from %s", e.md5,
                      e.parent or "peer")
        return admitted

    def _peer_round(self, fuzzer, reg) -> None:
        """Gossip hook — the manager-only client has no peers."""

    def _flush_quarantine(self, fuzzer, reg) -> None:
        """Write the round's rejected rows to the quarantine store
        (when a durable corpus exists) and count them; subclasses
        strike the offending peers here too."""
        if not self._quarantined_round:
            return
        batch = self._quarantined_round
        self._quarantined_round = []
        qstore = (QuarantineStore(fuzzer.store.root)
                  if fuzzer.store is not None else None)
        for buf, reason, peer in batch:
            self.quarantined_n += 1
            who = peer or "manager"
            WARNING_MSG("corpus sync: quarantined entry from %s "
                        "(%s)", who, reason)
            if qstore is not None and buf:
                qstore.put(buf, reason, peer=who)
        reg.count("sync_quarantined", len(batch))
        fuzzer.telemetry.event(
            "sync_quarantine", n=len(batch),
            reasons=sorted({r for _, r, _ in batch}))
