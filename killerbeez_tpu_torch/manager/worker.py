"""Fleet worker + assimilator — the BOINC-client replacement.

Lifecycle parity with the reference's BOINC path (SURVEY §3.5):
claim a workunit from the manager, run the fuzzer on it, then
assimilate — stage each finding file to the manager and POST a result
row per finding (crash | hang | new_path, the same result-type mapping
as server/killerbeez_assimilator.py:36-39) — and mark the job done
(with the mutator state for resumption).

    python -m killerbeez_tpu_torch.manager.worker http://mgr:8650 --once

Jobs run the port's CLI (``python -m killerbeez_tpu_torch.fuzzer``),
on the card by default; ``--device cpu`` runs them, and the crash
re-verification, on the CPU.  The worker never picks the CPU itself.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shlex
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from .. import FUZZ_CRASH
from ..utils.logging import INFO_MSG, WARNING_MSG, setup_logging

RESULT_DIRS = {"crashes": "crash", "hangs": "hang",
               "new_paths": "new_path"}


def _request(url: str, payload: Optional[Dict[str, Any]] = None,
             method: str = "POST") -> Any:
    # chaos seam: every manager RPC (work claim, heartbeat, corpus
    # sync, event forward) can be made to 500 or partition mid-round
    from ..resilience.chaos import chaos_point
    chaos_point("manager_rpc", url=url)
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        if resp.status == 204:
            return None
        body = resp.read()
        return json.loads(body) if body else None


def _request_retry(url: str, payload: Optional[Dict[str, Any]] = None,
                   method: str = "POST", attempts: int = 5,
                   base_delay: float = 0.5) -> Any:
    """_request with exponential backoff on transport errors (manager
    restarts, DCN blips): 0.5s, 1s, 2s, 4s between tries.  HTTP-level
    errors (4xx/5xx with a response) are NOT retried — they mean the
    manager saw the request and rejected it."""
    last: Optional[Exception] = None
    for attempt in range(attempts):
        try:
            return _request(url, payload, method)
        except urllib.error.HTTPError:
            raise
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            last = e
            if attempt + 1 < attempts:
                delay = base_delay * (2 ** attempt)
                WARNING_MSG("request to %s failed (%s); retry in "
                            "%.1fs", url, e, delay)
                time.sleep(delay)
    raise last  # type: ignore[misc]


# the heartbeat's stats.jsonl tailer: O(1) tail window + torn-line
# tolerance, shared with kb-stats (telemetry.sink)
from ..telemetry import TERMINAL_EVENTS, read_latest_snapshot  # noqa: E402


class Heartbeat(threading.Thread):
    """Progress reporter for one running job: every ``interval``
    seconds, POST the job's latest telemetry snapshot to the
    manager's ``/api/stats/<campaign>`` and forward any new TERMINAL
    events (crash / hang / plateau) from the job's ``events.jsonl``
    to ``/api/events/<campaign>`` (retry-with-backoff; a dead manager
    degrades to warnings — the fuzz run itself never stops for
    observability)."""

    def __init__(self, manager_url: str, campaign: str, worker: str,
                 output_dir: str, interval: float = 5.0,
                 tier: Optional[str] = None):
        super().__init__(daemon=True)
        self.url = f"{manager_url}/api/stats/{campaign}"
        self.events_url = f"{manager_url}/api/events/{campaign}"
        self.worker = worker
        self.output_dir = output_dir
        self.interval = interval
        self._halt = threading.Event()
        self._ev_pos = 0                 # events.jsonl bytes consumed
        self._ev_ino = None              # inode the cursor belongs to
        self._ev1_pos = 0                # first-beat drain cursor (.1)
        self._ev1_done = False
        self.sent = 0
        self.events_sent = 0
        #: worker identity forwarded with each beat — the manager's
        #: health registry stores it as fleet_workers.meta
        try:
            import socket
            self.meta = {"pid": os.getpid(),
                         "host": socket.gethostname()}
        except OSError:
            self.meta = {"pid": os.getpid()}
        # execution tier tag (hybrid campaigns; docs/HYBRID.md) —
        # absent means "tpu" to every per-tier fold
        if tier:
            self.meta["tier"] = tier

    #: per-beat read window over events.jsonl: bounds memory and
    #: request size — a long backlog (worker restart against a
    #: resumed campaign's log) drains across beats instead of one
    #: whole-file read + one giant POST
    EV_WINDOW = 256 << 10

    def _read_terminal_window(self, path: str, pos: int):
        """One bounded read at ``pos``: returns (terminal event
        records from the COMPLETE lines, bytes consumed) — (.., 0)
        when nothing complete is available."""
        try:
            with open(path, "rb") as f:
                f.seek(pos)
                chunk = f.read(self.EV_WINDOW)
        except OSError:
            return [], 0
        nl = chunk.rfind(b"\n")
        if nl < 0:
            return [], 0
        events = []
        for line in chunk[:nl].splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and \
                    rec.get("type") in TERMINAL_EVENTS:
                events.append(rec)
        return events, nl + 1

    def _post_events(self, events) -> bool:
        if not events:
            return True
        try:
            _request_retry(self.events_url,
                           {"worker": self.worker, "events": events},
                           attempts=3)
        except Exception as e:
            WARNING_MSG("event forward to %s failed: %s",
                        self.events_url, e)
            return False
        self.events_sent += len(events)
        return True

    def _forward_events(self) -> int:
        """Ship terminal events appended since the last beat.  Only
        COMPLETE lines advance the cursor (a torn tail line stays for
        the next beat); on transport failure the cursor rewinds — the
        manager dedups by (worker, seq, t), so a re-send is
        harmless.  An ``--events-max-mb`` rotation (live file shrinks
        below the cursor) drains the rotated generation's tail from
        ``events.jsonl.1`` first, then restarts the cursor at the
        fresh live file."""
        path = os.path.join(self.output_dir, "events.jsonl")
        if not self._ev1_done:
            # first beats: a burst of events can rotate the log
            # BEFORE the heartbeat ever reads it, so the rotated
            # generation must be drained once up front (re-sends are
            # dedup-safe; the .1 file is bounded by the cap)
            while True:
                tail, used = self._read_terminal_window(
                    path + ".1", self._ev1_pos)
                if used == 0:
                    self._ev1_done = True
                    break
                if not self._post_events(tail):
                    return 0             # retry the same spot later
                self._ev1_pos += used
        try:
            st = os.stat(path)
        except OSError:
            st = None
        rotated = (self._ev_ino is not None
                   and (st is None or st.st_ino != self._ev_ino
                        or st.st_size < self._ev_pos))
        if rotated:
            # rotated under us (the cursor's inode is now
            # events.jsonl.1): finish the previous generation — the
            # .1 file is bounded by the rotation cap, so this drain
            # is bounded too — then restart at byte 0 of the fresh
            # live file.  Only one generation is kept on disk: a
            # double rotation within one beat loses the middle one.
            while True:
                tail, used = self._read_terminal_window(
                    path + ".1", self._ev_pos)
                if used == 0:
                    break
                if not self._post_events(tail):
                    return 0             # retry the same spot later
                self._ev_pos += used
            self._ev_pos = 0
            self._ev_ino = None
        if st is None:
            return 0
        self._ev_ino = st.st_ino
        events, consumed = self._read_terminal_window(path,
                                                      self._ev_pos)
        if consumed == 0:
            return 0
        if not self._post_events(events):
            return 0                     # cursor unmoved: re-read
        self._ev_pos += consumed
        return len(events)

    def beat(self) -> bool:
        self._forward_events()
        snap = read_latest_snapshot(self.output_dir)
        if snap is None:
            return False
        try:
            _request_retry(self.url,
                           {"worker": self.worker, "snapshot": snap,
                            "meta": self.meta},
                           attempts=3)
            self.sent += 1
            return True
        except Exception as e:
            WARNING_MSG("heartbeat to %s failed after retries: %s",
                        self.url, e)
            return False

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        """Stop the loop and send one final snapshot (the job's
        cumulative totals; makes short jobs visible even when they
        finish inside the first interval)."""
        self._halt.set()
        self.join(timeout=self.interval + 1)
        self.beat()


def verify_repro(job: Dict[str, Any], content: bytes,
                 cache: Optional[Dict[str, Any]] = None,
                 device: str = "cuda") -> Dict[str, Any]:
    """Re-run a crash repro ONCE before posting the result — the
    reference's server flow traces results back through verification
    (docs/Server.md:215-258); the repo's analogue re-executes the
    repro under the richest available tier and attaches what it saw:

      * device targets (jit_harness / ipt): re-execute on the KBVM,
        report the verdict + exit code;
      * host targets (afl / return_code, file or stdin driver): re-run
        under the ptrace debug instrumentation, harvesting
        signal / fault address / module-relative PC;
      * network deliveries can't be replayed without the live session
        and are marked unverifiable.

    ``device`` is where the repro runs (the card unless the worker was
    started with ``--device cpu``).
    """
    instr_name = job.get("instrumentation", "")
    driver = job.get("driver", "")
    try:
        dopts = json.loads(job["driver_opts"]) \
            if job.get("driver_opts") else {}
    except (ValueError, TypeError):
        dopts = {}
    try:
        if instr_name in ("jit_harness", "ipt"):
            from ..instrumentation.factory import instrumentation_factory
            # one device instrumentation per job (the cache) — a fresh
            # instance per crash file would re-upload the program and
            # re-allocate the virgin maps for every finding
            instr = (cache or {}).get("device_instr")
            if instr is None:
                instr = instrumentation_factory(
                    instr_name, job.get("instrumentation_opts"),
                    device=device)
                if cache is not None:
                    cache["device_instr"] = instr
            instr.enable(content)
            st = instr.get_fuzz_result()
            if cache is None:
                instr.cleanup()
            return {"verified": st == FUZZ_CRASH, "tier": "device",
                    "status": int(st)}
        if driver not in ("file", "stdin"):
            return {"verified": None,
                    "reason": f"{driver} delivery is not replayable"}
        path = dopts.get("path")
        if not path or not os.path.exists(path):
            return {"verified": False,
                    "error": "target binary unavailable on this worker"}
        from ..instrumentation.debug import DebugInstrumentation
        dbg = DebugInstrumentation(None, device=device)
        args = (dopts.get("arguments") or "").strip()
        if driver == "stdin":
            dbg.enable(content,
                       cmd_line=f"{path} {args}".strip())
        else:
            fd, tmp = tempfile.mkstemp(prefix="kb_repro_")
            try:
                os.write(fd, content)
                os.close(fd)
                args = (dopts.get("arguments") or "@@").replace("@@", tmp)
                dbg.enable(None, cmd_line=f"{path} {args}")
            finally:
                os.unlink(tmp)
        verified = dbg.get_fuzz_result() == FUZZ_CRASH
        out: Dict[str, Any] = {"verified": verified, "tier": "debug"}
        if verified:
            out.update(dbg.last_crash_info)
            out["description"] = dbg.crash_description()
        dbg.cleanup()
        return out
    except Exception as e:   # verification must never block reporting
        return {"verified": False, "error": str(e)[:200]}


def assimilate(manager_url: str, job: Dict[str, Any],
               output_dir: str, device: str = "cuda") -> int:
    """Upload findings and create result rows (crashes re-verified
    first, details attached to the row); returns count."""
    n = 0
    job_id = job["id"]
    verify_cache: Dict[str, Any] = {}
    try:
        for sub, result_type in RESULT_DIRS.items():
            d = os.path.join(output_dir, sub)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), "rb") as f:
                    content = f.read()
                up = _request(f"{manager_url}/api/file", {
                    "name": f"job{job_id}_{sub}_{name}",
                    "content_b64": base64.b64encode(content).decode()})
                payload = {
                    "result_type": result_type,
                    "repro_file": f"/api/file/{up['id']}",
                }
                if result_type == "crash":
                    payload["crash_info"] = json.dumps(
                        verify_repro(job, content, verify_cache,
                                     device))
                _request(f"{manager_url}/api/job/{job_id}/results",
                         payload)
                n += 1
    finally:
        if "device_instr" in verify_cache:
            verify_cache["device_instr"].cleanup()
    return n


def run_job(manager_url: str, job: Dict[str, Any],
            in_process: bool = False, worker_name: str = "anon",
            heartbeat_s: float = 5.0,
            corpus_sync_s: float = 10.0,
            gossip: bool = False, device: str = "cuda") -> str:
    """Execute one claimed job; returns 'done' or 'failed'.  While
    the fuzzer runs, a heartbeat thread tails its stats.jsonl and
    POSTs progress snapshots to the manager (campaign key = job id),
    so the fleet view updates DURING long campaigns, not just at
    assimilation time.  The fuzzer also runs with a local corpus
    store synced through the manager's ``/api/corpus/<job id>``
    (``corpus_sync_s`` cadence; 0 disables) — fleet workers on the
    same campaign fuzz each other's frontiers instead of rediscovering
    them.  ``device`` "cpu" appends ``--device cpu`` to the fuzzer's
    argv (the port's CLI runs on the card by default)."""
    with tempfile.TemporaryDirectory(prefix="kb_work_") as workdir:
        out_dir = os.path.join(workdir, "output")
        argv = shlex.split(job["cmdline"]) + ["-o", out_dir]
        if device != "cuda":
            argv += ["--device", device]
        if corpus_sync_s > 0:
            argv += ["--corpus-dir", os.path.join(workdir, "corpus"),
                     "--sync-manager", manager_url,
                     "--sync-campaign", str(job["id"]),
                     "--sync-worker", worker_name,
                     "--sync-interval", str(corpus_sync_s)]
            if gossip:
                # peer-to-peer corpus gossip (ephemeral sidecar
                # port; the fuzzer registers it with the manager's
                # peer directory)
                argv += ["--gossip", "0"]
        hb = Heartbeat(manager_url, str(job["id"]), worker_name,
                       out_dir, interval=heartbeat_s)
        hb.start()
        try:
            if in_process:
                from ..fuzzer.cli import main as fuzzer_main
                # strip the "python -m killerbeez_tpu_torch.fuzzer"
                # prefix
                mod = "killerbeez_tpu_torch.fuzzer"
                tail = argv[argv.index(mod) + 1:] if mod in argv else argv
                rc = fuzzer_main(tail)
            else:
                rc = subprocess.run(argv).returncode
        finally:
            hb.stop()
        status = "done" if rc == 0 else "failed"
        found = assimilate(manager_url, job, out_dir, device)
        INFO_MSG("job %d %s: %d findings, %d heartbeats",
                 job["id"], status, found, hb.sent)
        return status


def work_loop(manager_url: str, worker_name: str, once: bool = False,
              poll_s: float = 2.0, in_process: bool = False,
              corpus_sync_s: float = 10.0,
              gossip: bool = False, device: str = "cuda") -> int:
    """Claim-run-report until the queue drains (once) or forever."""
    done = 0
    while True:
        job = _request_retry(f"{manager_url}/api/work/claim",
                             {"worker": worker_name})
        if job is None:
            if once:
                return done
            time.sleep(poll_s)
            continue
        try:
            status = run_job(manager_url, job, in_process=in_process,
                             worker_name=worker_name,
                             corpus_sync_s=corpus_sync_s,
                             gossip=gossip, device=device)
        except Exception as e:  # job must not wedge the worker
            WARNING_MSG("job %s failed: %s", job.get("id"), e)
            status = "failed"
        _request_retry(f"{manager_url}/api/work/{job['id']}/finish",
                       {"status": status})
        done += 1


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-worker",
        description="claim and run fuzzing jobs from a manager")
    p.add_argument("manager_url", help="e.g. http://127.0.0.1:8650")
    p.add_argument("--name", default=f"worker-{os.getpid()}")
    p.add_argument("--once", action="store_true",
                   help="drain the queue then exit")
    p.add_argument("--in-process", action="store_true",
                   help="run jobs in this interpreter (no subprocess)")
    p.add_argument("--corpus-sync", type=float, default=10.0,
                   help="seconds between fleet corpus-sync rounds "
                        "through /api/corpus/<job id> (0 disables; "
                        "default 10)")
    p.add_argument("--gossip", action="store_true",
                   help="run each job with peer-to-peer corpus "
                        "gossip (--gossip on the fuzzer: sidecar + "
                        "fanout pulls via the manager's peer "
                        "directory; corpus flow survives a dead or "
                        "partitioned manager)")
    p.add_argument("--device", default="cuda",
                   help='where jobs run: "cuda" (default: the card) or '
                        '"cpu" (appends --device cpu to each job)')
    p.add_argument("-l", "--logging-options")
    args = p.parse_args(argv)
    setup_logging(args.logging_options)
    # chaos harness: a supervised/chaos-tested worker picks its fault
    # spec up from KBZ_CHAOS (the manager_rpc seam in _request fires
    # nothing otherwise)
    from ..resilience.chaos import configure_from_env
    configure_from_env()
    n = work_loop(args.manager_url, args.name, once=args.once,
                  in_process=args.in_process,
                  corpus_sync_s=args.corpus_sync,
                  gossip=args.gossip, device=args.device)
    INFO_MSG("worker finished: %d jobs", n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
