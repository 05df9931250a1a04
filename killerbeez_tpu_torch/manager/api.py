"""Manager REST API — stdlib ThreadingHTTPServer.

Route parity with the reference manager (python/manager/app/
__init__.py:38-53: Job, Results, Target, Config, File, Minimize),
plus the work-queue routes that replace BOINC's scheduler
(SURVEY §2.8, §3.5):

    POST /api/target                 {name, platform, path} -> {id}
    GET  /api/target                 -> [targets]
    POST /api/config                 {name, value, target_id?}
    GET  /api/config?name=&target_id= -> {value}
    POST /api/job                    {target_id, driver, ...} -> {id, cmdline}
    GET  /api/job[?status=]          -> [jobs]
    GET  /api/job/<id>               -> job
    GET  /api/job/<id>/results       -> [results]
    POST /api/job/<id>/results       {result_type, repro_file}
    GET  /api/results                -> [results]
    POST /api/file                   {name, content_b64} -> {id}
    GET  /api/file/<id>              -> raw bytes
    POST /api/state                  {target_id, state} -> {id}
    GET  /api/state/<target_id>      -> [states]
    POST /api/tracer_info            {target_id, input_file, edges}
    POST /api/minimize               {target_id} -> {working_set}
    POST /api/work/claim             {worker} -> job+cmdline | 204
    POST /api/work/<id>/finish       {status, mutator_state?}
    POST /api/stats/<campaign>       {worker, snapshot}  (heartbeat)
    GET  /api/stats/<campaign>       -> {merged, workers, n_workers}
    POST /api/corpus/<campaign>      {worker, md5, cov_hash,
                                      content_b64, meta} -> {id, new}
    GET  /api/corpus/<campaign>?since=&exclude=
                                     -> {entries, latest}
    POST /api/events/<campaign>      {worker, events} -> {stored}
    GET  /api/events/<campaign>?since=<id>
                                     -> {events, latest}
    POST /api/peers/<campaign>       {worker, endpoint} -> {peers}
                                     (gossip registration + directory
                                      in one round trip)
    GET  /api/peers/<campaign>[?exclude=] -> {peers}
    GET  /api/health                 -> {ok, degraded, journal}

Durability: admission POSTs (corpus, events) append to the
write-ahead journal BEFORE the DB write and the journal replays on
restart, so a manager SIGKILL between ACK and commit loses nothing.
A DB write failure (ENOSPC, lock convoy) flips the manager into
READ-ONLY DEGRADED mode: cursor GETs keep serving, journal-backed
admission POSTs still ACK (``journaled: true``), and everything else
returns 503 with ``degraded: true`` instead of tearing down the
fleet's sync rounds.  The first successful write clears the latch.

plus the fleet observatory (manager/fleet.py):

    GET  /api/fleet                  -> {campaigns: {name: counts}}
    GET  /api/fleet/<campaign>       -> worker health + merged stats
                                        + alert states
    GET  /api/fleet/<campaign>/series?since=<id>[&limit=][&format=plot]
                                     -> {samples, latest} | plot_data
    GET  /metrics                    -> OpenMetrics exposition
                                        (Prometheus scrape surface)
"""

from __future__ import annotations

import base64
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..telemetry import merge
from ..telemetry.openmetrics import CONTENT_TYPE as _OM_CTYPE
from ..tools.minimize import greedy_edge_cover
from ..utils.logging import INFO_MSG, WARNING_MSG
from .db import ManagerDB, ManagerWriteError
from .fleet import (
    FleetConfig, FleetMonitor, fleet_index, fleet_view,
    peer_directory, render_fleet_metrics,
)
from .fuzzer_cmd import format_cmdline
from .journal import AdmissionJournal


class _Handler(BaseHTTPRequestHandler):
    db: ManagerDB  # set by ManagerServer
    fleet_config: FleetConfig
    monitor: Optional[FleetMonitor] = None
    journal: Optional[AdmissionJournal] = None

    # -- plumbing -------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet; manager logs itself
        pass

    def _json(self, code: int, obj: Any) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, code: int, data: bytes,
               ctype: str = "application/octet-stream") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n).decode())

    def _route(self, method: str) -> None:
        parsed = urlparse(self.path)
        path, query = parsed.path, parse_qs(parsed.query)
        try:
            for pattern, methods in _ROUTES:
                m = re.fullmatch(pattern, path)
                if m and method in methods:
                    methods[method](self, query, *m.groups())
                    return
            self._json(404, {"error": f"no route {method} {path}"})
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
        except ManagerWriteError as e:
            # read-only degraded mode: a failed DB write must not
            # tear the connection down as an opaque 500 — the worker
            # backs off on a clean, classified signal instead
            self._json(503, {"error": f"manager write-degraded: {e}",
                             "degraded": True})

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def _recover_journal(self) -> None:
        """DB writes are succeeding again: replay any journal-only
        backlog ACKed during the degraded window NOW, not at some
        future restart — cursor GETs must start serving those rows
        as soon as the disk lets them land.  Gated on the one-shot
        degraded->healthy transition (``consume_recovery``), NOT on
        the raw uncommitted counter: that counter is transiently
        nonzero whenever any concurrent POST sits between its append
        and its DB write, and gating on it would re-replay the whole
        journal inline in handler threads under perfectly healthy
        load.  The same (lock-holding, idempotent) replay doubles as
        compaction when the file outgrows its cap."""
        j = self.journal
        if j is None or self.db.degraded:
            return
        if not (self.db.consume_recovery() or j.needs_compact()):
            return
        try:
            j.replay(self.db)
        except Exception as e:
            WARNING_MSG("in-process journal recovery failed "
                        "(kept for restart): %s", e)

    # -- handlers -------------------------------------------------------

    def h_target(self, query):
        if self.command == "POST":
            b = self._body()
            tid = self.db.create_target(b["name"],
                                        b.get("platform", "linux_x86_64"),
                                        b.get("path", ""))
            self._json(201, {"id": tid})
        else:
            self._json(200, self.db.get_targets())

    def h_config(self, query):
        if self.command == "POST":
            b = self._body()
            self.db.set_config(b["name"], b["value"], b.get("target_id"))
            self._json(201, {"ok": True})
        else:
            name = query["name"][0]
            tid = int(query["target_id"][0]) if "target_id" in query \
                else None
            self._json(200, {"value": self.db.lookup_config(name, tid)})

    def h_job_collection(self, query):
        if self.command == "POST":
            b = self._body()
            jid = self.db.create_job(
                int(b["target_id"]), b["driver"], b["instrumentation"],
                b["mutator"], int(b.get("iterations", 1000)),
                b.get("seed_file", ""),
                driver_opts=b.get("driver_opts"),
                instrumentation_opts=b.get("instrumentation_opts"),
                mutator_opts=b.get("mutator_opts"),
                mutator_state=b.get("mutator_state"))
            job = self.db.get_job(jid)
            target = self.db.get_target(job["target_id"]) or {}
            self._json(201, {
                "id": jid,
                "cmdline": format_cmdline(
                    job, target.get("platform", "linux_x86_64")),
            })
        else:
            status = query.get("status", [None])[0]
            self._json(200, self.db.get_jobs(status))

    def h_job(self, query, job_id):
        job = self.db.get_job(int(job_id))
        if job is None:
            self._json(404, {"error": f"no job {job_id}"})
        else:
            self._json(200, job)

    def h_job_results(self, query, job_id):
        if self.command == "POST":
            b = self._body()
            rid = self.db.add_result(int(job_id), b["result_type"],
                                     b["repro_file"],
                                     b.get("crash_info"))
            self._json(201, {"id": rid})
        else:
            self._json(200, self.db.get_results(int(job_id)))

    def h_results(self, query):
        self._json(200, self.db.get_results())

    def h_file_collection(self, query):
        b = self._body()
        fid = self.db.add_file(
            b["name"], base64.b64decode(b["content_b64"]))
        self._json(201, {"id": fid})

    def h_file(self, query, file_id):
        row = self.db.get_file(int(file_id))
        if row is None:
            self._json(404, {"error": f"no file {file_id}"})
        else:
            self._bytes(200, row["content"])

    def h_state_collection(self, query):
        b = self._body()
        sid = self.db.add_instrumentation_state(int(b["target_id"]),
                                                b["state"])
        self._json(201, {"id": sid})

    def h_state(self, query, target_id):
        self._json(200, self.db.get_instrumentation_states(
            int(target_id)))

    def h_tracer_info(self, query):
        b = self._body()
        self.db.add_tracer_info(int(b["target_id"]), b["input_file"],
                                list(b["edges"]))
        self._json(201, {"ok": True})

    def h_minimize(self, query):
        """Greedy edge-cover working set from tracer_info rows
        (reference controller/Minimize.py:10-40)."""
        b = self._body()
        info = self.db.get_tracer_info(int(b["target_id"]))
        kept = greedy_edge_cover({k: set(v) for k, v in info.items()})
        self._json(200, {"working_set": kept,
                         "total_inputs": len(info)})

    def h_stats(self, query, campaign):
        """Worker heartbeat sink + fleet view: POST stores one
        worker's cumulative registry snapshot (latest wins), GET
        returns the telemetry.aggregate merge of every worker's
        newest snapshot plus per-worker freshness — the
        afl-whatsup-style campaign rollup."""
        if self.command == "POST":
            b = self._body()
            worker = b.get("worker", "anon")
            self.db.upsert_campaign_stats(campaign, worker,
                                          b["snapshot"])
            # health registry: the heartbeat IS the liveness signal;
            # a stale/dead worker beating again flips back to healthy
            # and the revival lands in the campaign event stream
            prev = self.db.note_fleet_worker(campaign, worker,
                                             meta=b.get("meta"))
            if prev in ("stale", "dead"):
                self.db.add_manager_event(campaign, "worker_returned",
                                          worker=worker,
                                          previous=prev)
            # heartbeats are the fleet's steady write pulse: the
            # first one to land after a degraded window drains the
            # journal backlog even if no admission POST follows
            self._recover_journal()
            self._json(201, {"ok": True})
            return
        rows = self.db.get_campaign_stats(campaign)
        self._json(200, {
            "campaign": campaign,
            "n_workers": len(rows),
            "workers": {r["worker"]: {"updated": r["updated"]}
                        for r in rows},
            "merged": merge([r["snapshot"] for r in rows]),
        })

    def h_corpus(self, query, campaign):
        """Fleet corpus exchange: POST stores one edge-novel entry
        (deduped by coverage hash — two workers hitting the same
        frontier store one row; the duplicate POST gets
        ``new: false``), GET returns entries newer than the caller's
        cursor so workers pull only each other's fresh findings.

        The POST journals BEFORE the DB write (a SIGKILL between the
        201 and the commit replays on restart), and a failed DB write
        still ACKs off the journal alone (``journaled: true``) — the
        ACK is the promise the fleet's reject rule depends on, so it
        must be backed by SOMETHING durable or refused outright."""
        if self.command == "POST":
            b = self._body()
            content = base64.b64decode(b["content_b64"])
            worker = b.get("worker", "anon")
            journaled = (self.journal is not None and
                         self.journal.append_corpus(
                             campaign, b["cov_hash"],
                             b.get("md5", ""), worker, content,
                             b.get("meta")))
            try:
                rid, new = self.db.add_corpus_entry(
                    campaign, b["cov_hash"], b.get("md5", ""),
                    worker, content, b.get("meta"))
            except ManagerWriteError as e:
                if not journaled:
                    raise               # nothing durable: honest 503
                WARNING_MSG("corpus POST held in journal only "
                            "(degraded): %s", e)
                self._json(201, {"id": None, "new": True,
                                 "journaled": True, "degraded": True})
                return
            if journaled:
                self.journal.note_committed()
            self._recover_journal()
            self._json(201 if new else 200, {"id": rid, "new": new})
            return
        since = int(query.get("since", ["0"])[0])
        exclude = query.get("exclude", [None])[0]
        rows = self.db.get_corpus_entries(campaign, since, exclude)
        latest = max((r["id"] for r in rows),
                     default=self.db.corpus_latest_id(campaign))
        self._json(200, {
            "campaign": campaign,
            "latest": latest,
            "entries": [{
                "id": r["id"], "md5": r["md5"],
                "cov_hash": r["cov_hash"], "worker": r["worker"],
                "content_b64":
                    base64.b64encode(r["content"]).decode(),
                "meta": r.get("meta"),
            } for r in rows],
        })

    def h_events(self, query, campaign):
        """Fleet event-log exchange (the flight recorder's terminal
        tier): POST stores a worker's forwarded event records (deduped
        by the worker's own monotone seq — a retried heartbeat window
        stores once), GET returns events newer than the caller's
        server-id cursor, mirroring ``/api/corpus`` semantics."""
        if self.command == "POST":
            b = self._body()
            worker = b.get("worker", "anon")
            events = b.get("events") or []
            journaled = (self.journal is not None and
                         self.journal.append_events(campaign, worker,
                                                    events))
            try:
                n = self.db.add_campaign_events(campaign, worker,
                                                events)
            except ManagerWriteError as e:
                if not journaled:
                    raise
                WARNING_MSG("events POST held in journal only "
                            "(degraded): %s", e)
                self._json(201, {"stored": len(events),
                                 "journaled": True, "degraded": True})
                return
            if journaled:
                self.journal.note_committed()
            self._recover_journal()
            self._json(201, {"stored": n})
            return
        since = int(query.get("since", ["0"])[0])
        rows = self.db.get_campaign_events(campaign, since)
        latest = max((r["id"] for r in rows),
                     default=self.db.events_latest_id(campaign))
        self._json(200, {
            "campaign": campaign,
            "latest": latest,
            "events": rows,
        })

    def h_peers(self, query, campaign):
        """Gossip peer directory: POST registers this worker's
        sidecar endpoint (into the SAME health registry heartbeats
        feed — a peer is live exactly when its worker is) and returns
        the current directory in the same response, so one round trip
        both advertises and discovers.  GET serves the directory
        read-only.  Dead workers drop out of the directory the same
        way they drop out of /api/fleet."""
        exclude = None
        if self.command == "POST":
            b = self._body()
            worker = str(b.get("worker", "anon"))
            endpoint = b.get("endpoint")
            if not isinstance(endpoint, str) or \
                    not endpoint.startswith("http") or \
                    len(endpoint) > 512:
                self._json(400, {"error": "bad gossip endpoint"})
                return
            exclude = worker
            try:
                self.db.note_fleet_worker(campaign, worker,
                                          meta={"gossip": endpoint})
            except ManagerWriteError as e:
                # registration is best-effort: a write-degraded
                # manager still serves the directory it has — the
                # phone book must outlive the pen
                WARNING_MSG("peer registration write failed "
                            "(degraded): %s", e)
        else:
            exclude = query.get("exclude", [None])[0]
        self._json(201 if self.command == "POST" else 200, {
            "campaign": campaign,
            "degraded": self.db.degraded,
            "peers": peer_directory(self.db, self.fleet_config,
                                    campaign, exclude=exclude),
        })

    def h_health(self, query):
        """Liveness + degraded-mode probe (kb-fleet, load balancers,
        the fleet-sim harness)."""
        j = self.journal
        self._json(200, {
            "ok": True,
            "degraded": self.db.degraded,
            "write_failures": self.db.write_failures,
            "journal": ({"appended": j.appended_n,
                         "uncommitted": j.uncommitted}
                        if j is not None else None),
        })

    # -- fleet observatory ---------------------------------------------

    def h_fleet_index(self, query):
        self._json(200, fleet_index(self.db, self.fleet_config))

    def h_fleet(self, query, campaign):
        """Worker health registry view: live-classified statuses,
        per-worker stat summaries, the merged fleet snapshot and the
        alert evaluator's current states."""
        self._json(200, fleet_view(self.db, self.fleet_config,
                                   campaign, self.monitor))

    def h_fleet_series(self, query, campaign):
        """Fleet time-series, cursor GET like ``/api/events``;
        ``format=plot`` renders the afl-plot-compatible fleet-wide
        plot_data CSV instead of JSON."""
        since = int(query.get("since", ["0"])[0])
        limit = int(query.get("limit", ["0"])[0])
        rows = self.db.get_fleet_series(campaign, since, limit)
        if query.get("format", [None])[0] == "plot":
            lines = ["# unix_time, execs_done, paths_total, crashes, "
                     "unique_crashes, hangs, unique_hangs, "
                     "corpus_count, execs_per_sec, n_workers"]
            for s in rows:
                lines.append(", ".join(str(v) for v in (
                    int(s.get("t", 0)), int(s.get("execs", 0)),
                    int(s.get("new_paths", 0)),
                    int(s.get("crashes", 0)),
                    int(s.get("unique_crashes", 0)),
                    int(s.get("hangs", 0)),
                    int(s.get("unique_hangs", 0)),
                    int(s.get("corpus_seen", 0)),
                    round(float(s.get("execs_per_sec_ema", 0.0)), 2),
                    int(s.get("n_workers", 0)))))
            self._bytes(200, ("\n".join(lines) + "\n").encode(),
                        ctype="text/plain; charset=utf-8")
            return
        # (not max()'s default= — that expression is evaluated
        # eagerly, costing a discarded MAX(id) query on every page)
        latest = (max(s["id"] for s in rows) if rows
                  else self.db.fleet_series_latest_id(campaign))
        self._json(200, {"campaign": campaign, "latest": latest,
                         "samples": rows})

    def h_metrics(self, query):
        """OpenMetrics exposition over every known campaign — the
        Prometheus scrape surface (conformance pinned in CI by the
        test suite's strict parser)."""
        text = render_fleet_metrics(self.db, self.fleet_config,
                                    self.monitor)
        self._bytes(200, text.encode(), ctype=_OM_CTYPE)

    def h_work_claim(self, query):
        b = self._body()
        job = self.db.claim_job(b.get("worker", "anon"))
        if job is None:
            self._bytes(204, b"")
            return
        target = self.db.get_target(job["target_id"]) or {}
        job["cmdline"] = format_cmdline(
            job, target.get("platform", "linux_x86_64"))
        self._json(200, job)

    def h_work_finish(self, query, job_id):
        b = self._body()
        self.db.finish_job(int(job_id), b.get("status", "done"),
                           b.get("mutator_state"))
        self._json(200, {"ok": True})


_ROUTES: Tuple = (
    (r"/api/target", {"GET": _Handler.h_target,
                      "POST": _Handler.h_target}),
    (r"/api/config", {"GET": _Handler.h_config,
                      "POST": _Handler.h_config}),
    (r"/api/job", {"GET": _Handler.h_job_collection,
                   "POST": _Handler.h_job_collection}),
    (r"/api/job/(\d+)", {"GET": _Handler.h_job}),
    (r"/api/job/(\d+)/results", {"GET": _Handler.h_job_results,
                                 "POST": _Handler.h_job_results}),
    (r"/api/results", {"GET": _Handler.h_results}),
    (r"/api/file", {"POST": _Handler.h_file_collection}),
    (r"/api/file/(\d+)", {"GET": _Handler.h_file}),
    (r"/api/state", {"POST": _Handler.h_state_collection}),
    (r"/api/state/(\d+)", {"GET": _Handler.h_state}),
    (r"/api/tracer_info", {"POST": _Handler.h_tracer_info}),
    (r"/api/stats/([\w.-]+)", {"GET": _Handler.h_stats,
                               "POST": _Handler.h_stats}),
    (r"/api/corpus/([\w.-]+)", {"GET": _Handler.h_corpus,
                                "POST": _Handler.h_corpus}),
    (r"/api/events/([\w.-]+)", {"GET": _Handler.h_events,
                                "POST": _Handler.h_events}),
    (r"/api/peers/([\w.-]+)", {"GET": _Handler.h_peers,
                               "POST": _Handler.h_peers}),
    (r"/api/health", {"GET": _Handler.h_health}),
    (r"/api/fleet", {"GET": _Handler.h_fleet_index}),
    (r"/api/fleet/([\w.-]+)", {"GET": _Handler.h_fleet}),
    (r"/api/fleet/([\w.-]+)/series", {"GET": _Handler.h_fleet_series}),
    (r"/metrics", {"GET": _Handler.h_metrics}),
    (r"/api/minimize", {"POST": _Handler.h_minimize}),
    (r"/api/work/claim", {"POST": _Handler.h_work_claim}),
    (r"/api/work/(\d+)/finish", {"POST": _Handler.h_work_finish}),
)


class ManagerServer:
    """Owns the HTTP server + DB; start()/stop() for embedding in
    tests, serve_forever() for the CLI."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8650,
                 db_path: str = ":memory:",
                 fleet: Optional[FleetConfig] = None,
                 journal_path: Optional[str] = None):
        self.db = ManagerDB(db_path)
        self.fleet_config = fleet or FleetConfig()
        # write-ahead admission journal: defaults on for file-backed
        # DBs (<db>.journal — durability should not be opt-in), off
        # for in-memory managers unless a path is given; REPLAYED
        # into the DB before the first request so a SIGKILL'd
        # manager restarts with every ACKed POST present
        if journal_path is None and db_path != ":memory:":
            journal_path = db_path + ".journal"
        self.journal: Optional[AdmissionJournal] = None
        if journal_path:
            self.journal = AdmissionJournal(journal_path)
            self.journal.replay(self.db)
        #: the observatory evaluator; its thread only starts with the
        #: server (monitor_interval <= 0 keeps it manual-tick-only —
        #: tests drive tick() deterministically)
        self.monitor = FleetMonitor(self.db, self.fleet_config)
        handler = type("BoundHandler", (_Handler,),
                       {"db": self.db,
                        "fleet_config": self.fleet_config,
                        "monitor": self.monitor,
                        "journal": self.journal})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    def _start_monitor(self) -> None:
        if self.fleet_config.monitor_interval > 0 \
                and not self.monitor.is_alive():
            self.monitor.start()

    def start(self) -> None:
        self._start_monitor()
        self._serving = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        INFO_MSG("manager listening on :%d", self.port)

    def serve_forever(self) -> None:
        self._start_monitor()
        self._serving = True
        INFO_MSG("manager listening on :%d", self.port)
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.monitor.stop()
        if self._serving:
            # shutdown() on a server whose serve_forever never ran
            # blocks forever (stdlib event handshake) — a constructed-
            # but-never-started server just closes its socket
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self.journal is not None:
            self.journal.close()
        self.db.close()
