"""Write-ahead admission journal — a manager SIGKILL loses zero
accepted POSTs.

The manager ACKs corpus entries and forwarded events with 201, and
The sync's reject rule makes workers DROP entries the manager has seen
(retrying an acknowledged row forever would poison every future
round).  That contract means the ACK must be durable: a SIGKILL
between the ACK and the sqlite commit — or an sqlite write that
fails outright (ENOSPC, ``database is locked`` beyond the retry
budget) — must not silently lose the row the fleet believes is safe.

So every admission POST appends ONE JSON line here *before* the DB
write (`append` flushes + fsyncs per record — admissions are rare
next to heartbeats, the durability is worth one fsync), and
``replay()`` re-applies the journal into the DB on restart.  Both
target tables dedup on natural keys (``corpus_entries``
UNIQUE(campaign, cov_hash), ``campaign_events`` UNIQUE(campaign,
worker, seq, t)), so replay is idempotent: records that DID commit
before the kill are no-ops.  A torn tail line (the kill landed
mid-append) is skipped exactly like ``events.jsonl`` readers skip
theirs.

After a clean replay the journal truncates; during a run it
truncates whenever every record is known committed and the file
exceeds ``compact_bytes`` — the journal is a crash window, not a
second database.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

from ..utils.logging import INFO_MSG, WARNING_MSG

#: journal record kinds -> the DB call replay re-applies
KIND_CORPUS = "corpus"
KIND_EVENTS = "events"


class AdmissionJournal:
    """Append-only, fsync-per-record, torn-tail-tolerant."""

    def __init__(self, path: str, compact_bytes: int = 32 << 20):
        self.path = str(path)
        self.compact_bytes = int(compact_bytes)
        self._lock = threading.Lock()
        self._fh = None
        #: records appended since the last truncate that are NOT yet
        #: known committed to the DB (degraded-mode backlog); when it
        #: hits zero the journal is safe to compact
        self.uncommitted = 0
        self.appended_n = 0

    # -- append (the POST handlers call this BEFORE the DB write) -------

    def append_corpus(self, campaign: str, cov_hash: str, md5: str,
                      worker: str, content: bytes,
                      meta: Optional[Dict[str, Any]]) -> bool:
        return self._append({
            "kind": KIND_CORPUS, "campaign": str(campaign),
            "cov_hash": cov_hash, "md5": md5, "worker": worker,
            "content_b64": base64.b64encode(content).decode(),
            "meta": meta})

    def append_events(self, campaign: str, worker: str,
                      events: list) -> bool:
        return self._append({
            "kind": KIND_EVENTS, "campaign": str(campaign),
            "worker": worker, "events": events})

    def _append(self, rec: Dict[str, Any]) -> bool:
        """One line + flush + fsync; returns False when even the
        journal cannot be written (the caller then has NO durability
        to offer and must refuse the POST)."""
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            try:
                if self._fh is None:
                    self._fh = open(self.path, "a")
                    # heal a torn tail before appending onto it
                    if self._fh.tell() > 0:
                        with open(self.path, "rb") as rf:
                            rf.seek(-1, os.SEEK_END)
                            if rf.read(1) != b"\n":
                                self._fh.write("\n")
                self._fh.write(line)
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError) as e:
                WARNING_MSG("admission journal append failed: %s", e)
                self._close_locked()
                return False
            self.uncommitted += 1
            self.appended_n += 1
        return True

    def note_committed(self, n: int = 1) -> None:
        """The DB write for ``n`` journaled records landed.  NEVER
        truncates: ``uncommitted`` is a plain counter, so "it hit
        zero" can coincide with another handler sitting between its
        append and its DB write — truncating here could destroy the
        only durable copy of an admission that was just ACKed
        journal-only.  The ONLY truncation path is ``replay()``,
        which holds the journal lock across read+apply+truncate, so
        every record in the file is in the DB before it goes."""
        with self._lock:
            self.uncommitted = max(0, self.uncommitted - int(n))

    def needs_compact(self) -> bool:
        """The file outgrew the cap — the API tier runs a (safe,
        lock-holding, idempotent) ``replay()`` to compact it when
        the DB is healthy."""
        try:
            return os.path.getsize(self.path) > self.compact_bytes
        except OSError:
            return False

    # -- replay (manager boot) ------------------------------------------

    def replay(self, db) -> Tuple[int, int]:
        """Re-apply every readable record into ``db`` (idempotent —
        natural-key dedup absorbs the already-committed ones), then
        truncate.  Returns (records replayed, records stored new).

        Holds the journal lock for the WHOLE read+apply+truncate:
        recovery replays run while request threads are live, and an
        append interleaved between the read and the truncate would
        be silently truncated away — losing the durability its ACK
        promised."""
        with self._lock:
            return self._replay_locked(db)

    def _replay_locked(self, db) -> Tuple[int, int]:
        replayed = stored = 0
        try:
            with open(self.path, "rb") as f:
                lines = f.read().splitlines()
        except OSError:
            return 0, 0
        db_failed = False
        for raw in lines:
            try:
                rec = json.loads(raw)
            except ValueError:
                continue                 # torn tail / corruption
            if not isinstance(rec, dict):
                continue
            try:
                kind = rec.get("kind")
                if kind == KIND_CORPUS:
                    _, new = db.add_corpus_entry(
                        rec["campaign"], rec["cov_hash"],
                        rec.get("md5", ""), rec.get("worker", "anon"),
                        base64.b64decode(rec["content_b64"]),
                        rec.get("meta"))
                    stored += int(bool(new))
                elif kind == KIND_EVENTS:
                    stored += db.add_campaign_events(
                        rec["campaign"], rec.get("worker", "anon"),
                        rec.get("events") or [])
                else:
                    continue
                replayed += 1
            except Exception as e:
                # a MALFORMED record is dropped (one bad line must
                # not wedge every boot), but a failed DB WRITE means
                # the DB is still sick — truncating now would destroy
                # the only durable copy of everything unapplied, so
                # keep the journal intact for the next recovery
                from .db import ManagerWriteError
                if isinstance(e, ManagerWriteError):
                    WARNING_MSG("journal replay aborted (DB still "
                                "failing): %s — journal kept", e)
                    db_failed = True
                    break
                WARNING_MSG("journal replay skipped a record: %s", e)
        if not db_failed:
            self.uncommitted = 0
            self._truncate_locked()
        if replayed:
            INFO_MSG("admission journal: replayed %d records "
                     "(%d stored new)", replayed, stored)
        return replayed, stored

    # -- internals ------------------------------------------------------

    def _close_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _truncate_locked(self) -> None:
        self._close_locked()
        try:
            with open(self.path, "w"):
                pass
        except OSError as e:
            WARNING_MSG("journal truncate failed: %s", e)

    def close(self) -> None:
        with self._lock:
            self._close_locked()
