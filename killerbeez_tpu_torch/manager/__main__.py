"""Manager CLI (reference python/manager/server.py parity, including
the ``--seed`` demo-row mode, server.py:13-44)."""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..utils.logging import INFO_MSG, setup_logging
from .api import ManagerServer
from .fleet import FleetConfig


def seed_demo_rows(server: ManagerServer) -> None:
    """Populate the DB with demo rows for API testing (reference
    tests/seeds.py client_request set)."""
    db = server.db
    tid = db.create_target("corpus_test", path="corpus/build/test")
    db.set_config("driver_opts_file",
                  json.dumps({"path": "corpus/build/test",
                              "arguments": "@@"}), tid)
    db.set_config("mutator_opts_bit_flip",
                  json.dumps({"num_bits": 2}))
    db.create_job(tid, "file", "afl", "bit_flip", iterations=100,
                  seed_file="corpus/seed.bin")
    db.create_job(tid, "file", "jit_harness", "havoc", iterations=4096,
                  instrumentation_opts=json.dumps({"target": "test"}))
    INFO_MSG("seeded demo rows: 1 target, 2 configs, 2 jobs")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="killerbeez-tpu-torch-manager",
        description="distributed fuzzing manager (REST + work queue)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8650)
    p.add_argument("--db", default=":memory:",
                   help="sqlite path (default in-memory); file-backed "
                        "DBs run WAL + busy-timeout with locked-write "
                        "retry")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="write-ahead admission journal path (default "
                        "<db>.journal for file-backed DBs, off for "
                        "in-memory): corpus/event POSTs are "
                        "journaled+fsynced before the DB write and "
                        "replayed on restart, so a manager SIGKILL "
                        "loses zero ACKed admissions and a failed DB "
                        "write degrades to journal-backed read-only "
                        "mode instead of 500ing the fleet")
    p.add_argument("--seed", action="store_true",
                   help="insert demo rows before serving")
    fl = p.add_argument_group(
        "fleet observatory",
        "worker health / alert thresholds (manager/fleet.py); the "
        "monitor classifies heartbeating workers, persists fleet "
        "time-series and serves /api/fleet + /metrics")
    fl.add_argument("--stale-after", type=float, default=15.0,
                    help="seconds without a heartbeat before a "
                         "worker reads stale (default 15)")
    fl.add_argument("--dead-after", type=float, default=60.0,
                    help="seconds before stale escalates to dead "
                         "(default 60)")
    fl.add_argument("--monitor-interval", type=float, default=2.0,
                    help="health/alert evaluation cadence in seconds "
                         "(default 2; 0 disables the monitor)")
    fl.add_argument("--series-interval", type=float, default=10.0,
                    help="seconds between persisted fleet time-"
                         "series samples (default 10)")
    fl.add_argument("--series-max-rows", type=int, default=20000,
                    help="newest fleet time-series samples kept per "
                         "campaign, oldest pruned (default 20000 "
                         "~= 2.3 days at the default interval; 0 = "
                         "unbounded)")
    fl.add_argument("--plateau-after", type=float, default=300.0,
                    help="fleet_plateau alert: seconds without a "
                         "fleet-wide new path (default 300)")
    fl.add_argument("--stall-after", type=float, default=900.0,
                    help="coverage_stall alert: paths flat this "
                         "long while execs advance (default 900)")
    fl.add_argument("--crash-spike-count", type=int, default=10,
                    help="crash_spike alert: unique crashes inside "
                         "the window (default 10)")
    fl.add_argument("--crash-spike-window", type=float, default=60.0,
                    help="crash_spike trailing window seconds "
                         "(default 60)")
    fl.add_argument("--drops-window", type=float, default=120.0,
                    help="findings_drop alert: active while the "
                         "fleet's findings_ring_drops counter moved "
                         "within this many seconds (--generations "
                         "ring overflow under-reports findings; "
                         "default 120)")
    fl.add_argument("--retire-after", type=float, default=86400.0,
                    help="seconds after a worker's last heartbeat "
                         "before its registry row + snapshot retire "
                         "entirely (finished campaigns stop alerting "
                         "and /metrics cardinality stays bounded; "
                         "default 86400 = 1 day, 0 = never)")
    p.add_argument("-l", "--logging-options")
    args = p.parse_args(argv)
    setup_logging(args.logging_options)
    fleet = FleetConfig(
        stale_after=args.stale_after, dead_after=args.dead_after,
        monitor_interval=args.monitor_interval,
        series_interval=args.series_interval,
        series_max_rows=args.series_max_rows,
        plateau_after=args.plateau_after,
        stall_after=args.stall_after,
        crash_spike_count=args.crash_spike_count,
        crash_spike_window=args.crash_spike_window,
        drops_window=args.drops_window,
        retire_after=args.retire_after)
    server = ManagerServer(args.host, args.port, args.db, fleet=fleet,
                           journal_path=args.journal)
    if args.seed:
        seed_demo_rows(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
