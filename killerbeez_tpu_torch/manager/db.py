"""Manager database — sqlite3 schema mirroring the reference's models
(python/manager/model/: FuzzingJob, FuzzingResults, FuzzingTarget,
Config, job_inputs, instrumentation_state, tracer_info — SURVEY §2.8).

sqlite stands in for MySQL/Postgres exactly as in the reference's test
config (python/manager/app/config.py:2-3). The connection is
per-thread (the REST tier serves from a thread pool).

Durability posture (the degraded-mode manager): file-backed
connections run in WAL mode with a busy timeout, every write retries
``database is locked`` with bounded backoff (a concurrent heartbeat
burst must not 500 a corpus POST — the worker would drop that entry
from the round forever under the sync's reject rule), and a write that
STILL fails (ENOSPC, lock convoy beyond the budget) raises a typed
:class:`ManagerWriteError` and latches ``self.degraded`` — the REST
tier then keeps serving cursor GETs read-only instead of 500ing the
fleet, with the admission journal (``journal.py``) holding the ACKed
rows until writes recover.  The first successful write clears the
latch.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

from ..resilience.chaos import chaos_point
from ..telemetry.events import SCHEMA_VERSION
from ..utils.logging import WARNING_MSG


class ManagerWriteError(Exception):
    """A DB mutation failed after the retry budget — the manager is
    write-degraded (reads keep serving; the API tier decides whether
    the journal can still honor the POST)."""

_SCHEMA = """
CREATE TABLE IF NOT EXISTS targets (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    platform TEXT NOT NULL DEFAULT 'linux_x86_64',
    path TEXT NOT NULL DEFAULT '',
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS configs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,           -- e.g. driver_opts_file
    target_id INTEGER,            -- NULL = global default
    value TEXT NOT NULL,
    UNIQUE(name, target_id)
);
CREATE TABLE IF NOT EXISTS jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    target_id INTEGER NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
        -- pending -> claimed -> done | failed
    driver TEXT NOT NULL,
    instrumentation TEXT NOT NULL,
    mutator TEXT NOT NULL,
    iterations INTEGER NOT NULL DEFAULT 1000,
    seed_file TEXT NOT NULL DEFAULT '',
    driver_opts TEXT, instrumentation_opts TEXT, mutator_opts TEXT,
    mutator_state TEXT,           -- resumption (model/FuzzingJob.py:14)
    instrumentation_state_id INTEGER,
    assigned_to TEXT, claimed REAL, finished REAL,
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS results (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_id INTEGER NOT NULL,
    result_type TEXT NOT NULL,    -- crash | hang | new_path
    repro_file TEXT NOT NULL,
    crash_info TEXT,              -- worker verification JSON (crashes)
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS job_inputs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_id INTEGER NOT NULL,
    file_id INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS files (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    content BLOB NOT NULL,
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS instrumentation_state (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    target_id INTEGER NOT NULL,
    state TEXT NOT NULL,
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS tracer_info (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    target_id INTEGER NOT NULL,
    input_file TEXT NOT NULL,
    edges TEXT NOT NULL,          -- JSON list of edge ids
    UNIQUE(target_id, input_file)
);
CREATE TABLE IF NOT EXISTS campaign_stats (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    campaign TEXT NOT NULL,       -- campaign key (job id by default)
    worker TEXT NOT NULL,
    snapshot TEXT NOT NULL,       -- telemetry registry snapshot JSON
    updated REAL NOT NULL,
    UNIQUE(campaign, worker)      -- latest heartbeat per worker
);
CREATE TABLE IF NOT EXISTS campaign_events (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    campaign TEXT NOT NULL,
    worker TEXT NOT NULL,
    seq INTEGER NOT NULL,         -- the worker's events.jsonl seq
    t REAL NOT NULL,              -- event wall time (worker clock)
    type TEXT NOT NULL,           -- crash | hang | plateau | ...
    payload TEXT NOT NULL,        -- full event record JSON
    created REAL NOT NULL,
    -- re-forwarded heartbeat windows dedup (identical record, same
    -- t); t is IN the key because seq is only monotone per log
    -- lifetime — a same-named worker restarting with a fresh output
    -- dir restarts seq at 0, and its events must still store
    UNIQUE(campaign, worker, seq, t)
);
CREATE TABLE IF NOT EXISTS fleet_workers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    campaign TEXT NOT NULL,
    worker TEXT NOT NULL,
    first_seen REAL NOT NULL,     -- first heartbeat (registration)
    last_seen REAL NOT NULL,      -- newest heartbeat
    beats INTEGER NOT NULL DEFAULT 0,
    status TEXT NOT NULL DEFAULT 'healthy',
        -- healthy | stale | dead (the monitor's last classification;
        -- endpoints re-classify live against last_seen)
    meta TEXT,                    -- worker-supplied JSON (pid, host)
    UNIQUE(campaign, worker)
);
CREATE TABLE IF NOT EXISTS fleet_series (
    id INTEGER PRIMARY KEY AUTOINCREMENT,  -- the GET cursor
    campaign TEXT NOT NULL,
    t REAL NOT NULL,
    sample TEXT NOT NULL          -- fleet snapshot JSON (monitor)
);
CREATE TABLE IF NOT EXISTS corpus_entries (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    campaign TEXT NOT NULL,
    cov_hash TEXT NOT NULL,       -- coverage-signature dedup key
    md5 TEXT NOT NULL,
    worker TEXT NOT NULL,
    content BLOB NOT NULL,
    meta TEXT,                    -- entry sidecar JSON (corpus store)
    created REAL NOT NULL,
    UNIQUE(campaign, cov_hash)    -- one row per coverage frontier
);
"""


class ManagerDB:
    """Thread-safe sqlite wrapper; rows in/out as plain dicts."""

    #: ``database is locked`` retry budget: attempts and base backoff
    #: (exponential: 10ms, 20ms, 40ms, 80ms, 160ms — bounded, so a
    #: true lock convoy still surfaces as ManagerWriteError instead
    #: of wedging the request thread)
    LOCK_RETRIES = 5
    LOCK_BACKOFF_S = 0.01
    #: sqlite busy handler budget (ms) — the first line of defense
    #: against cross-process writers before our retry loop engages
    BUSY_TIMEOUT_MS = 2000

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._local = threading.local()
        # in-memory DBs are per-connection; share one with a lock
        self._shared: Optional[sqlite3.Connection] = None
        self._lock = threading.Lock()
        #: write-degraded latch: set when a mutation exhausts the
        #: retry budget, cleared by the next successful write; the
        #: API tier serves read-only (plus journal-backed admission
        #: ACKs) while it is up
        self.degraded = False
        self.write_failures = 0
        #: one-shot recovery signal: set when the degraded latch
        #: CLEARS (a write succeeded after a failing window) — the
        #: API tier consumes it to replay the journal backlog
        #: exactly once per recovery, never on the healthy hot path
        self.recovery_pending = False
        if path == ":memory:":
            self._shared = sqlite3.connect(":memory:",
                                           check_same_thread=False)
            self._shared.row_factory = sqlite3.Row
            self._shared.executescript(_SCHEMA)
            self._migrate(self._shared)
        else:
            with self._conn() as c:
                c.executescript(_SCHEMA)
                self._migrate(c)

    @staticmethod
    def _migrate(conn: sqlite3.Connection) -> None:
        """Columns added after a release: CREATE TABLE IF NOT EXISTS
        skips existing tables, so upgrades need explicit ALTERs."""
        cols = {r[1] for r in conn.execute(
            "PRAGMA table_info(results)")}
        if "crash_info" not in cols:
            conn.execute(
                "ALTER TABLE results ADD COLUMN crash_info TEXT")

    def _conn(self) -> sqlite3.Connection:
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            conn.row_factory = sqlite3.Row
            # durability pragmas (file-backed only): WAL lets cursor
            # GETs read while a write commits, NORMAL sync is safe
            # under WAL (a power cut loses at most the last commit,
            # which the admission journal replays), and the busy
            # handler absorbs cross-process lock contention before
            # our own retry loop has to
            try:
                conn.execute("PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA synchronous=NORMAL")
                conn.execute(
                    f"PRAGMA busy_timeout={self.BUSY_TIMEOUT_MS}")
            except sqlite3.Error as e:
                WARNING_MSG("sqlite pragma setup failed: %s", e)
            self._local.conn = conn
        return conn

    def _write(self, conn: sqlite3.Connection, sql: str,
               params: tuple = ()) -> sqlite3.Cursor:
        """One mutation through the degraded-mode seam: chaos point,
        bounded ``database is locked`` retry, ManagerWriteError +
        degraded latch on exhaustion, latch cleared on success.
        Caller holds ``self._lock`` and commits."""
        last: Optional[Exception] = None
        try:
            # chaos seam: the manager write path — enospc/raise here
            # is how tests drive the manager into (and out of)
            # degraded mode; the url context is the statement head
            # ("INSERT INTO corpus_entries"), so ``match`` can scope
            # a fault to one table's writes
            chaos_point("manager_db_write",
                        url=" ".join(sql.split()[:3]))
        except Exception as e:          # injected fault = failed write
            last = e
        for attempt in range(self.LOCK_RETRIES if last is None else 0):
            try:
                cur = conn.execute(sql, params)
                if self.degraded:
                    self.degraded = False
                    self.recovery_pending = True
                return cur
            except sqlite3.OperationalError as e:
                msg = str(e).lower()
                if "locked" not in msg and "busy" not in msg:
                    last = e
                    break
                last = e
                time.sleep(self.LOCK_BACKOFF_S * (2 ** attempt))
            except (sqlite3.Error, OSError) as e:
                last = e
                break
        self.degraded = True
        self.write_failures += 1
        try:
            conn.rollback()     # never leave an open write txn on a
        except sqlite3.Error:   # shared connection
            pass
        raise ManagerWriteError(str(last))

    def consume_recovery(self) -> bool:
        """One-shot: True exactly once after a degraded->healthy
        transition (the caller then replays the journal backlog)."""
        if self.recovery_pending and not self.degraded:
            self.recovery_pending = False
            return True
        return False

    def _commit(self, conn: sqlite3.Connection) -> None:
        """Commit through the degraded seam: under WAL a disk-full
        or busy failure can surface at COMMIT time (appending the
        -wal file), not at execute — it must latch degraded and
        raise the typed error just like a failed execute, or the
        fleet sees raw 500s instead of the journal-backed 503."""
        try:
            conn.commit()
        except (sqlite3.Error, OSError) as e:
            self.degraded = True
            self.write_failures += 1
            try:
                conn.rollback()
            except sqlite3.Error:
                pass
            raise ManagerWriteError(str(e))

    def _exec(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            conn = self._conn()
            cur = self._write(conn, sql, params)
            self._commit(conn)
            return cur

    def _rows(self, sql: str, params: tuple = ()) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in
                    self._conn().execute(sql, params).fetchall()]

    # -- targets --------------------------------------------------------

    def create_target(self, name: str, platform: str = "linux_x86_64",
                      path: str = "") -> int:
        cur = self._exec(
            "INSERT INTO targets (name, platform, path, created) "
            "VALUES (?, ?, ?, ?)", (name, platform, path, time.time()))
        return cur.lastrowid

    def get_targets(self) -> List[Dict[str, Any]]:
        return self._rows("SELECT * FROM targets")

    def get_target(self, target_id: int) -> Optional[Dict[str, Any]]:
        rows = self._rows("SELECT * FROM targets WHERE id = ?",
                          (target_id,))
        return rows[0] if rows else None

    # -- configs (reference lookup_config, model/FuzzingJob.py:52-74) ---

    def set_config(self, name: str, value: str,
                   target_id: Optional[int] = None) -> None:
        self._exec(
            "INSERT INTO configs (name, target_id, value) VALUES (?,?,?) "
            "ON CONFLICT(name, target_id) DO UPDATE SET value=excluded.value",
            (name, target_id, value))

    def lookup_config(self, name: str,
                      target_id: Optional[int] = None) -> Optional[str]:
        """Per-target value wins over the global default (reference
        job->target config resolution)."""
        if target_id is not None:
            rows = self._rows(
                "SELECT value FROM configs WHERE name=? AND target_id=?",
                (name, target_id))
            if rows:
                return rows[0]["value"]
        rows = self._rows(
            "SELECT value FROM configs WHERE name=? AND target_id IS NULL",
            (name,))
        return rows[0]["value"] if rows else None

    # -- jobs -----------------------------------------------------------

    def create_job(self, target_id: int, driver: str,
                   instrumentation: str, mutator: str,
                   iterations: int = 1000, seed_file: str = "",
                   **opts) -> int:
        """Option strings not given explicitly resolve through the
        config table as ``{type}_opts_{name}`` rows."""
        resolved = {}
        for kind, name in (("driver", driver),
                           ("instrumentation", instrumentation),
                           ("mutator", mutator)):
            key = f"{kind}_opts"
            resolved[key] = opts.get(key) or self.lookup_config(
                f"{kind}_opts_{name}", target_id)
        cur = self._exec(
            "INSERT INTO jobs (target_id, driver, instrumentation, "
            "mutator, iterations, seed_file, driver_opts, "
            "instrumentation_opts, mutator_opts, mutator_state, created) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (target_id, driver, instrumentation, mutator, iterations,
             seed_file, resolved["driver_opts"],
             resolved["instrumentation_opts"], resolved["mutator_opts"],
             opts.get("mutator_state"), time.time()))
        return cur.lastrowid

    def get_job(self, job_id: int) -> Optional[Dict[str, Any]]:
        rows = self._rows("SELECT * FROM jobs WHERE id = ?", (job_id,))
        return rows[0] if rows else None

    def get_jobs(self, status: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
        if status:
            return self._rows("SELECT * FROM jobs WHERE status = ?",
                              (status,))
        return self._rows("SELECT * FROM jobs")

    def claim_job(self, worker: str) -> Optional[Dict[str, Any]]:
        """Atomically hand the oldest pending job to ``worker`` (the
        BOINC scheduler-request replacement)."""
        with self._lock:
            conn = self._conn()
            row = conn.execute(
                "SELECT id FROM jobs WHERE status='pending' "
                "ORDER BY id LIMIT 1").fetchone()
            if row is None:
                return None
            self._write(
                conn,
                "UPDATE jobs SET status='claimed', assigned_to=?, "
                "claimed=? WHERE id=?",
                (worker, time.time(), row["id"]))
            self._commit(conn)
            job = conn.execute("SELECT * FROM jobs WHERE id=?",
                               (row["id"],)).fetchone()
            return dict(job)

    def finish_job(self, job_id: int, status: str = "done",
                   mutator_state: Optional[str] = None) -> None:
        self._exec(
            "UPDATE jobs SET status=?, finished=?, "
            "mutator_state=COALESCE(?, mutator_state) WHERE id=?",
            (status, time.time(), mutator_state, job_id))

    def requeue_stale_jobs(self, older_than_s: float) -> int:
        """Claimed-but-never-finished jobs go back to pending (BOINC
        workunit retry semantics — fleet-level failure recovery)."""
        cutoff = time.time() - older_than_s
        cur = self._exec(
            "UPDATE jobs SET status='pending', assigned_to=NULL "
            "WHERE status='claimed' AND claimed < ?", (cutoff,))
        return cur.rowcount

    # -- results --------------------------------------------------------

    def add_result(self, job_id: int, result_type: str,
                   repro_file: str,
                   crash_info: Optional[str] = None) -> int:
        if result_type not in ("crash", "hang", "new_path"):
            raise ValueError(f"bad result_type {result_type!r}")
        cur = self._exec(
            "INSERT INTO results (job_id, result_type, repro_file, "
            "crash_info, created) VALUES (?,?,?,?,?)",
            (job_id, result_type, repro_file, crash_info, time.time()))
        return cur.lastrowid

    def get_results(self, job_id: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
        if job_id is not None:
            return self._rows("SELECT * FROM results WHERE job_id = ?",
                              (job_id,))
        return self._rows("SELECT * FROM results")

    # -- files ----------------------------------------------------------

    def add_file(self, name: str, content: bytes) -> int:
        cur = self._exec(
            "INSERT INTO files (name, content, created) VALUES (?,?,?)",
            (name, content, time.time()))
        return cur.lastrowid

    def get_file(self, file_id: int) -> Optional[Dict[str, Any]]:
        rows = self._rows("SELECT * FROM files WHERE id = ?", (file_id,))
        return rows[0] if rows else None

    # -- instrumentation state -----------------------------------------

    def add_instrumentation_state(self, target_id: int,
                                  state: str) -> int:
        cur = self._exec(
            "INSERT INTO instrumentation_state (target_id, state, "
            "created) VALUES (?,?,?)", (target_id, state, time.time()))
        return cur.lastrowid

    def get_instrumentation_states(self, target_id: int
                                   ) -> List[Dict[str, Any]]:
        return self._rows(
            "SELECT * FROM instrumentation_state WHERE target_id = ?",
            (target_id,))

    # -- campaign stats (worker heartbeat snapshots) -------------------

    def upsert_campaign_stats(self, campaign: str, worker: str,
                              snapshot: Dict[str, Any]) -> None:
        """Latest-wins per (campaign, worker): heartbeats carry full
        cumulative snapshots, so only the newest matters."""
        self._exec(
            "INSERT INTO campaign_stats (campaign, worker, snapshot, "
            "updated) VALUES (?,?,?,?) ON CONFLICT(campaign, worker) "
            "DO UPDATE SET snapshot=excluded.snapshot, "
            "updated=excluded.updated",
            (str(campaign), worker, json.dumps(snapshot), time.time()))

    def get_campaign_stats(self, campaign: str
                           ) -> List[Dict[str, Any]]:
        rows = self._rows(
            "SELECT worker, snapshot, updated FROM campaign_stats "
            "WHERE campaign = ? ORDER BY worker", (str(campaign),))
        for r in rows:
            r["snapshot"] = json.loads(r["snapshot"])
        return rows

    # -- fleet worker health registry ----------------------------------

    def note_fleet_worker(self, campaign: str, worker: str,
                          meta: Optional[Dict[str, Any]] = None,
                          now: Optional[float] = None
                          ) -> Optional[str]:
        """Record one heartbeat in the health registry: first beat
        registers the worker (first_seen), every beat refreshes
        last_seen and resets status to healthy.  Returns the PREVIOUS
        status (None for a new worker) so the caller can emit a
        ``worker_returned`` event when a stale/dead worker revives."""
        now = time.time() if now is None else now
        with self._lock:
            conn = self._conn()
            row = conn.execute(
                "SELECT status, meta FROM fleet_workers WHERE "
                "campaign=? AND worker=?",
                (str(campaign), worker)).fetchone()
            prev = row["status"] if row is not None else None
            # meta MERGES per key instead of replacing wholesale: the
            # gossip tier registers {"gossip": endpoint} through
            # /api/peers while heartbeats register {pid, host} — the
            # later writer must not clobber the other's keys
            if meta is not None and row is not None and row["meta"]:
                try:
                    old = json.loads(row["meta"])
                    if isinstance(old, dict):
                        meta = {**old, **meta}
                except ValueError:
                    pass
            self._write(
                conn,
                "INSERT INTO fleet_workers (campaign, worker, "
                "first_seen, last_seen, beats, status, meta) "
                "VALUES (?,?,?,?,1,'healthy',?) "
                "ON CONFLICT(campaign, worker) DO UPDATE SET "
                "last_seen=excluded.last_seen, beats=beats+1, "
                "status='healthy', "
                "meta=COALESCE(excluded.meta, meta)",
                (str(campaign), worker, now, now,
                 json.dumps(meta) if meta is not None else None))
            self._commit(conn)
        return prev

    def get_fleet_workers(self, campaign: Optional[str] = None
                          ) -> List[Dict[str, Any]]:
        if campaign is not None:
            rows = self._rows(
                "SELECT * FROM fleet_workers WHERE campaign=? "
                "ORDER BY worker", (str(campaign),))
        else:
            rows = self._rows(
                "SELECT * FROM fleet_workers ORDER BY campaign, "
                "worker")
        for r in rows:
            if r.get("meta"):
                try:
                    r["meta"] = json.loads(r["meta"])
                except ValueError:
                    r["meta"] = None
        return rows

    def set_fleet_worker_status(self, campaign: str, worker: str,
                                status: str,
                                expect_last_seen: Optional[float]
                                = None) -> bool:
        """Update a worker's stored status; with ``expect_last_seen``
        the write only lands if no heartbeat slipped in since the
        caller read the row (note_fleet_worker bumps last_seen under
        the same DB lock) — the monitor uses this so a beat racing
        the tick can't get a spurious worker_stale/worker_dead
        recorded over its fresh 'healthy'.  Returns whether the
        update applied."""
        if expect_last_seen is None:
            cur = self._exec(
                "UPDATE fleet_workers SET status=? WHERE campaign=? "
                "AND worker=?", (status, str(campaign), worker))
        else:
            cur = self._exec(
                "UPDATE fleet_workers SET status=? WHERE campaign=? "
                "AND worker=? AND last_seen=?",
                (status, str(campaign), worker,
                 float(expect_last_seen)))
        return cur.rowcount > 0

    def retire_fleet_workers(self, cutoff: float) -> int:
        """Drop health-registry rows (and their heartbeat snapshots)
        whose last beat predates ``cutoff`` — a finished campaign's
        workers leave the observatory instead of reading dead
        forever; fleet_series keeps the campaign's history."""
        with self._lock:
            conn = self._conn()
            cur = self._write(
                conn,
                "DELETE FROM fleet_workers WHERE last_seen < ?",
                (float(cutoff),))
            # snapshots follow the registry: a worker with no
            # registry row left has retired (any live worker's next
            # heartbeat re-registers it immediately)
            self._write(
                conn,
                "DELETE FROM campaign_stats WHERE NOT EXISTS "
                "(SELECT 1 FROM fleet_workers fw WHERE "
                "fw.campaign=campaign_stats.campaign AND "
                "fw.worker=campaign_stats.worker)")
            self._commit(conn)
            return cur.rowcount

    def fleet_campaigns(self) -> List[str]:
        """Every campaign the observatory knows: health-registry rows
        union heartbeat-snapshot rows."""
        rows = self._rows(
            "SELECT campaign FROM fleet_workers UNION "
            "SELECT campaign FROM campaign_stats ORDER BY campaign")
        return [r["campaign"] for r in rows]

    # -- fleet time-series (history that survives worker churn) -------

    def add_fleet_sample(self, campaign: str,
                         sample: Dict[str, Any],
                         max_rows: int = 0) -> int:
        """Insert one fleet sample; with ``max_rows`` > 0 the oldest
        rows beyond the cap are pruned in the same call, so the
        history table stays bounded however long the manager runs
        (cursors stay valid — ids only ever disappear from the old
        end)."""
        cur = self._exec(
            "INSERT INTO fleet_series (campaign, t, sample) "
            "VALUES (?,?,?)",
            (str(campaign), float(sample.get("t", time.time())),
             json.dumps(sample)))
        if max_rows > 0:
            self._exec(
                "DELETE FROM fleet_series WHERE campaign=? AND id "
                "NOT IN (SELECT id FROM fleet_series WHERE "
                "campaign=? ORDER BY id DESC LIMIT ?)",
                (str(campaign), str(campaign), int(max_rows)))
        return cur.lastrowid

    def get_fleet_series(self, campaign: str, since_id: int = 0,
                         limit: int = 0) -> List[Dict[str, Any]]:
        """Samples newer than the caller's cursor (``/api/events``
        since semantics); ``limit`` > 0 caps the page."""
        sql = ("SELECT id, t, sample FROM fleet_series WHERE "
               "campaign=? AND id>? ORDER BY id")
        params: tuple = (str(campaign), int(since_id))
        if limit > 0:
            sql += " LIMIT ?"
            params += (int(limit),)
        rows = self._rows(sql, params)
        out = []
        for r in rows:
            try:
                sample = json.loads(r["sample"])
            except ValueError:
                continue
            sample["id"] = r["id"]
            sample.setdefault("t", r["t"])
            out.append(sample)
        return out

    def fleet_series_latest_id(self, campaign: str) -> int:
        rows = self._rows(
            "SELECT MAX(id) AS m FROM fleet_series WHERE campaign=?",
            (str(campaign),))
        return int(rows[0]["m"] or 0) if rows else 0

    # -- campaign events (flight-recorder exchange) --------------------

    def add_campaign_events(self, campaign: str, worker: str,
                            events: List[Dict[str, Any]]) -> int:
        """Store forwarded event records, deduped by the worker's own
        (seq, t) — a retried heartbeat re-POSTs the same window and
        one row survives, while a restarted worker whose fresh log
        reuses seq 0 still stores (its wall times differ).  Returns
        how many were stored as new."""
        stored = 0
        with self._lock:
            conn = self._conn()
            for e in events:
                if not isinstance(e, dict) or "seq" not in e:
                    continue
                try:
                    seq, t = int(e["seq"]), float(e.get("t", 0.0))
                except (TypeError, ValueError):
                    continue             # malformed record: skip
                cur = self._write(
                    conn,
                    "INSERT INTO campaign_events (campaign, worker, "
                    "seq, t, type, payload, created) "
                    "VALUES (?,?,?,?,?,?,?) "
                    "ON CONFLICT(campaign, worker, seq, t) "
                    "DO NOTHING",
                    (str(campaign), worker, seq, t,
                     str(e.get("type", "")), json.dumps(e),
                     time.time()))
                stored += cur.rowcount
            self._commit(conn)
        return stored

    #: pseudo-worker name for manager-origin records (health
    #: transitions, alerts) in the campaign event stream
    MANAGER_WORKER = "_manager"

    def add_manager_event(self, campaign: str, etype: str,
                          now: Optional[float] = None,
                          **fields) -> Dict[str, Any]:
        """Emit one manager-origin record into the campaign stream
        under the ``_manager`` pseudo-worker with its own monotone
        seq, so cursor GETs, kb-timeline merging and the heartbeat
        dedup key apply to manager events unchanged."""
        now = time.time() if now is None else now
        with self._lock:
            conn = self._conn()
            row = conn.execute(
                "SELECT MAX(seq) AS m FROM campaign_events WHERE "
                "campaign=? AND worker=?",
                (str(campaign), self.MANAGER_WORKER)).fetchone()
            seq = int(row["m"] if row and row["m"] is not None
                      else -1) + 1
            rec: Dict[str, Any] = {"v": SCHEMA_VERSION, "seq": seq,
                                   "t": now, "type": str(etype)}
            rec.update(fields)
            self._write(
                conn,
                "INSERT INTO campaign_events (campaign, worker, seq, "
                "t, type, payload, created) VALUES (?,?,?,?,?,?,?) "
                "ON CONFLICT(campaign, worker, seq, t) DO NOTHING",
                (str(campaign), self.MANAGER_WORKER, seq, float(now),
                 str(etype), json.dumps(rec, default=str),
                 time.time()))
            self._commit(conn)
        return rec

    def get_campaign_events(self, campaign: str, since_id: int = 0
                            ) -> List[Dict[str, Any]]:
        """Events newer than the caller's server-id cursor (mirrors
        the corpus exchange's since semantics)."""
        rows = self._rows(
            "SELECT id, worker, payload FROM campaign_events "
            "WHERE campaign=? AND id>? ORDER BY id",
            (str(campaign), int(since_id)))
        out = []
        for r in rows:
            try:
                event = json.loads(r["payload"])
            except ValueError:
                continue
            out.append({"id": r["id"], "worker": r["worker"],
                        "event": event})
        return out

    def events_latest_id(self, campaign: str) -> int:
        rows = self._rows(
            "SELECT MAX(id) AS m FROM campaign_events WHERE campaign=?",
            (str(campaign),))
        return int(rows[0]["m"] or 0) if rows else 0

    # -- corpus exchange (fleet seed sharing) --------------------------

    def add_corpus_entry(self, campaign: str, cov_hash: str, md5: str,
                         worker: str, content: bytes,
                         meta: Optional[Dict[str, Any]] = None
                         ) -> tuple:
        """Store one corpus entry; dedup by (campaign, cov_hash) —
        two workers hitting the same coverage frontier store ONE row.
        Returns (row id, stored_as_new)."""
        with self._lock:
            conn = self._conn()
            cur = self._write(
                conn,
                "INSERT INTO corpus_entries (campaign, cov_hash, md5, "
                "worker, content, meta, created) VALUES (?,?,?,?,?,?,?) "
                "ON CONFLICT(campaign, cov_hash) DO NOTHING",
                (str(campaign), cov_hash, md5, worker, content,
                 json.dumps(meta) if meta is not None else None,
                 time.time()))
            self._commit(conn)
            if cur.rowcount:
                return cur.lastrowid, True
            row = conn.execute(
                "SELECT id FROM corpus_entries WHERE campaign=? AND "
                "cov_hash=?", (str(campaign), cov_hash)).fetchone()
            return (row["id"] if row else None), False

    def get_corpus_entries(self, campaign: str, since_id: int = 0,
                           exclude_worker: Optional[str] = None
                           ) -> List[Dict[str, Any]]:
        """Entries newer than ``since_id`` (the puller's cursor),
        optionally excluding the puller's own uploads."""
        if exclude_worker is not None:
            rows = self._rows(
                "SELECT * FROM corpus_entries WHERE campaign=? AND "
                "id>? AND worker != ? ORDER BY id",
                (str(campaign), int(since_id), exclude_worker))
        else:
            rows = self._rows(
                "SELECT * FROM corpus_entries WHERE campaign=? AND "
                "id>? ORDER BY id", (str(campaign), int(since_id)))
        for r in rows:
            if r.get("meta"):
                try:
                    r["meta"] = json.loads(r["meta"])
                except ValueError:
                    r["meta"] = None
        return rows

    def corpus_latest_id(self, campaign: str) -> int:
        rows = self._rows(
            "SELECT MAX(id) AS m FROM corpus_entries WHERE campaign=?",
            (str(campaign),))
        return int(rows[0]["m"] or 0) if rows else 0

    # -- tracer info / minimization ------------------------------------

    def add_tracer_info(self, target_id: int, input_file: str,
                        edges: List[int]) -> None:
        self._exec(
            "INSERT INTO tracer_info (target_id, input_file, edges) "
            "VALUES (?,?,?) ON CONFLICT(target_id, input_file) "
            "DO UPDATE SET edges=excluded.edges",
            (target_id, input_file, json.dumps(sorted(set(edges)))))

    def get_tracer_info(self, target_id: int) -> Dict[str, List[int]]:
        rows = self._rows(
            "SELECT input_file, edges FROM tracer_info WHERE target_id=?",
            (target_id,))
        return {r["input_file"]: json.loads(r["edges"]) for r in rows}

    def close(self) -> None:
        if self._shared is not None:
            self._shared.close()
