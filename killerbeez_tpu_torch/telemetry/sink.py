"""Snapshot writers — AFL-ecosystem-compatible campaign stats files.

Three artifacts under ``<output>/``, refreshed on a wall-clock
interval from the fuzzing loop's own thread (no background thread:
``maybe_flush()`` is a cheap time check per batch):

  * ``fuzzer_stats``  — ``key = value`` lines, the AFL contract
    (afl-whatsup, FMViz and every dashboard in that ecosystem parse
    this).  Written atomically: tmp file + ``os.replace`` so a tailer
    never sees a torn write.
  * ``plot_data``     — append-only CSV of cumulative counters, one
    row per flush (afl-plot's input).  Monotone by construction.
  * ``stats.jsonl``   — one full registry snapshot per flush
    (structured stream for kb-stats and the manager heartbeat).

All writes degrade to a warning: telemetry must never kill a
campaign over a full disk.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from ..utils.fileio import ensure_dir
from ..utils.logging import WARNING_MSG
from .metrics import MetricsRegistry

PLOT_FIELDS = ("unix_time", "execs_done", "paths_total", "crashes",
               "unique_crashes", "hangs", "unique_hangs",
               "corpus_count", "execs_per_sec")


def _corpus_seen(snap: Dict[str, object]) -> float:
    """The seen-corpus gauge, tolerating pre-split snapshots that
    still carry the conflated ``corpus_size`` name."""
    g = snap.get("gauges", {})
    return g.get("corpus_seen", g.get("corpus_size", 0))


def write_fuzzer_stats(path: str, snap: Dict[str, object],
                       extra: Optional[Dict[str, object]] = None
                       ) -> None:
    """Atomic ``key = value`` dump of one snapshot (AFL layout)."""
    c = snap.get("counters", {})
    d = snap.get("derived", {})
    g = snap.get("gauges", {})
    rows = {
        "start_time": int(snap.get("start_time", 0)),
        "last_update": int(snap.get("t", 0)),
        # AFL's find-recency epochs (afl-whatsup reads these to call a
        # campaign stuck/alive); sourced from the flight recorder's
        # event timestamps, mirrored as gauges so fleet merges take
        # the max — "most recent find anywhere" — automatically
        "last_path": int(g.get("last_path", 0)),
        "last_crash": int(g.get("last_crash", 0)),
        "last_hang": int(g.get("last_hang", 0)),
        "run_time": int(snap.get("elapsed", 0)),
        "fuzzer_pid": os.getpid(),
        "execs_done": int(c.get("execs", 0)),
        "execs_per_sec": round(d.get("execs_per_sec", 0.0), 2),
        "execs_per_sec_ema": round(d.get("execs_per_sec_ema", 0.0), 2),
        "paths_total": int(c.get("new_paths", 0)),
        "crashes": int(c.get("crashes", 0)),
        "unique_crashes": int(c.get("unique_crashes", 0)),
        "hangs": int(c.get("hangs", 0)),
        "unique_hangs": int(c.get("unique_hangs", 0)),
        "exec_errors": int(c.get("errors", 0)),
        # corpus_count stays the AFL wire name; the source gauge is
        # corpus_seen (distinct new-path inputs ever recorded —
        # corpus_size is the pre-split name, read for old snapshots)
        "corpus_count": int(_corpus_seen(snap)),
        "corpus_arms": int(snap.get("gauges", {})
                           .get("corpus_arms", 0)),
        "afl_version": "killerbeez-tpu",
    }
    if extra:
        rows.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for k, v in rows.items():
            f.write(f"{k:<18}: {v}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)               # atomic on POSIX


def plot_row(snap: Dict[str, object]) -> str:
    c = snap.get("counters", {})
    d = snap.get("derived", {})
    vals = (int(snap.get("t", 0)), int(c.get("execs", 0)),
            int(c.get("new_paths", 0)), int(c.get("crashes", 0)),
            int(c.get("unique_crashes", 0)), int(c.get("hangs", 0)),
            int(c.get("unique_hangs", 0)),
            int(_corpus_seen(snap)),
            round(d.get("execs_per_sec", 0.0), 2))
    return ", ".join(str(v) for v in vals)


class StatsSink:
    """Owns the three files for one campaign output directory."""

    def __init__(self, output_dir: str, registry: MetricsRegistry,
                 interval_s: float = 5.0):
        self.output_dir = output_dir
        self.registry = registry
        self.interval_s = float(interval_s)
        self._last_flush = 0.0          # first maybe_flush() writes
        self._plot_header_done = False
        try:
            ensure_dir(output_dir)
        except OSError as e:
            WARNING_MSG("stats dir unavailable: %s", e)

    # -- paths ----------------------------------------------------------

    @property
    def fuzzer_stats_path(self) -> str:
        return os.path.join(self.output_dir, "fuzzer_stats")

    @property
    def plot_data_path(self) -> str:
        return os.path.join(self.output_dir, "plot_data")

    @property
    def jsonl_path(self) -> str:
        return os.path.join(self.output_dir, "stats.jsonl")

    # -- writing --------------------------------------------------------

    def maybe_flush(self) -> bool:
        """Flush if the interval elapsed; cheap no-op otherwise."""
        now = self.registry._time()
        if now - self._last_flush < self.interval_s:
            return False
        self.flush()
        return True

    def flush(self) -> None:
        snap = self.registry.snapshot()
        self._last_flush = snap["t"]
        try:
            write_fuzzer_stats(self.fuzzer_stats_path, snap)
            mode = "a" if self._plot_header_done else "w"
            with open(self.plot_data_path, mode) as f:
                if not self._plot_header_done:
                    f.write("# " + ", ".join(PLOT_FIELDS) + "\n")
                    self._plot_header_done = True
                f.write(plot_row(snap) + "\n")
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        except OSError as e:
            WARNING_MSG("stats flush failed: %s", e)


def parse_fuzzer_stats(path: str) -> Dict[str, str]:
    """Read a ``key = value`` file back into a dict (tooling/tests)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = v.strip()
    return out


def read_latest_snapshot(path: str,
                         window: int = 1 << 16
                         ) -> Optional[Dict[str, object]]:
    """Newest complete snapshot from a ``stats.jsonl`` (or its
    output directory) — the shared tailer behind the worker
    heartbeat and kb-stats.  Reads only the last ``window`` bytes
    (O(1) however long the campaign has run) and walks backwards to
    the first line that parses, so a record torn mid-append never
    drops the beat — the previous complete record serves instead."""
    if os.path.isdir(path):
        path = os.path.join(path, "stats.jsonl")
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - window))
            chunk = f.read()
    except OSError:
        return None
    for line in reversed(chunk.splitlines()):
        if line.strip():
            try:
                return json.loads(line)
            except ValueError:
                continue    # torn tail or window-truncated head
    return None
