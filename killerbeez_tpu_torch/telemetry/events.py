"""Campaign event log — the flight recorder's history tier.

A finished campaign used to leave only aggregate counters; this
module gives it a durable timeline: ``events.jsonl`` under the output
dir records WHEN the things that shape a campaign happened — finds,
plateaus, crack injections, sync rounds, scheduler rotations, stats
flushes — one JSON record per line, schema-versioned, append-only.
FMViz (arxiv 2112.13207) is the model: post-hoc visualization of
campaign history is a first-class fuzzing tool, and it needs the
history to exist.

Record schema (``SCHEMA_VERSION`` 1)::

    {"v": 1, "seq": N, "t": <unix time>, "type": <EVENT_TYPES>,
     ...type-specific fields}

``seq`` is monotone per log file ACROSS restarts: a resumed campaign
scans the existing tail and continues numbering, so cursors
(``kb-timeline``, the manager's ``/api/events`` exchange) never see a
seq twice.  Writes follow the stats sink's crash discipline — one
buffered ``write()`` + flush per record, warnings instead of raises,
and readers skip torn tail lines.

Event type contract (what reconciles against ``fuzzer_stats``):

* ``new_path``  — one per ``new_paths`` counter increment
* ``crash``     — one per ``unique_crashes`` increment (the raw
  ``crashes`` running total rides in the record)
* ``hang``      — one per ``unique_hangs`` increment
* ``plateau`` / ``crack_injection`` — the crack stage's trigger and
  its injection outcome
* ``sync_round`` — one per corpus-sync round that ran
* ``scheduler_pick`` — one per seed rotation
* ``flush``     — one per stats-file flush
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

from ..resilience.chaos import chaos_point
from ..utils.fileio import ensure_dir
from ..utils.logging import WARNING_MSG

SCHEMA_VERSION = 1

EVENT_TYPES = ("new_path", "crash", "hang", "plateau",
               "crack_injection", "sync_round", "scheduler_pick",
               "flush",
               # fleet-observatory records (manager-origin: the
               # worker health registry and the alert evaluator emit
               # these into the same campaign stream)
               "worker_stale", "worker_dead", "worker_returned",
               "alert",
               # resilience records (resilience/): a dispatch the
               # watchdog had to kill, and a classified device loss
               # the supervisor will re-probe for
               "watchdog_stall", "device_lost",
               # --generations: the host-side replay of one device
               # seed-slot ring admission (the device-resident loop's
               # analogue of scheduler_pick + admission)
               "ring_admit",
               # partition-tolerant fleet (corpus/gossip.py +
               # quarantine.py): one peer-exchange round, a batch of
               # rejected synced-in entries, and a peer crossing the
               # poison threshold into a timed ban
               "gossip_round", "sync_quarantine", "peer_banned",
               # stateful session tier (killerbeez_tpu/stateful/):
               # the state x edge coverage high-water rose — pairs =
               # touched (state, edge) buckets, states = distinct
               # protocol states seen (kb-timeline's session section)
               "state_cov",
               # learned mutation shaping (killerbeez_tpu/learn/):
               # one completed on-device training round of the
               # byte-saliency model — version, label counts, the
               # final batch loss
               "learn_update",
               # hybrid bridge (killerbeez_tpu/hybrid/): one cross-
               # tier validation verdict — a TPU-tier finding
               # replayed on the real native binary, with md5, kind,
               # verdict (confirmed / proxy_only / flaky), repro
               # counts and wall time (docs/HYBRID.md)
               "cross_tier_validate",
               # hybrid bridge: a proxy_only divergence — the soft
               # proxy crashed where the native binary did not; the
               # event names the machine-readable gap report path
               "proxy_gap")

#: events a fleet worker forwards to the manager alongside heartbeats
TERMINAL_EVENTS = ("crash", "hang", "plateau")

EVENTS_FILE = "events.jsonl"

#: rotated-out predecessor (``--events-max-mb``): at most one
#: generation is kept — rotation replaces any previous ``.1``
ROTATED_SUFFIX = ".1"


def _resolve_path(path: str) -> str:
    if os.path.isdir(path) or not path.endswith(".jsonl"):
        return os.path.join(path, EVENTS_FILE)
    return path


def _scan_tail_seq(path: str, window: int) -> int:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - window))
            chunk = f.read()
    except OSError:
        return -1
    best = -1
    for line in chunk.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                continue                 # foreign/scalar line
            best = max(best, int(rec.get("seq", -1)))
        except (ValueError, TypeError):
            continue                     # torn tail / truncated head
    return best


def last_event_seq(path: str, window: int = 1 << 16) -> int:
    """Highest seq among the readable records in the file's tail
    window (-1 when none) — the resume anchor.  O(1) in file size,
    torn-tail tolerant, same discipline as the heartbeat tailer.  A
    log that was just rotated (empty live file) anchors on the
    rotated predecessor's tail, so seq stays monotone across both
    rotation and ``--resume``."""
    path = _resolve_path(path)
    best = _scan_tail_seq(path, window)
    if best < 0:
        best = _scan_tail_seq(path + ROTATED_SUFFIX, window)
    return best


def read_events(path: str, since_seq: int = -1,
                types: Optional[List[str]] = None
                ) -> Iterator[Dict[str, Any]]:
    """Yield records with seq > ``since_seq`` (optionally filtered by
    type), skipping unparseable lines.  The rotated predecessor
    (``events.jsonl.1``) is read first when present, so consumers
    (kb-timeline, reconciliation) see one seamless stream across a
    ``--events-max-mb`` rotation."""
    path = _resolve_path(path)
    for p in (path + ROTATED_SUFFIX, path):
        try:
            f = open(p)
        except OSError:
            continue
        with f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                try:
                    if int(rec.get("seq", -1)) <= since_seq:
                        continue
                except (TypeError, ValueError):
                    continue             # foreign/corrupt record

                if types is not None and rec.get("type") not in types:
                    continue
                yield rec


class EventLog:
    """Append-only writer for one campaign's ``events.jsonl``.

    ``fresh=True`` truncates any existing log and restarts seq at 0 —
    a NEW campaign reusing an output dir must not inherit the previous
    run's timeline (its counters restart too, so stale events would
    break reconciliation and re-forward old terminal events); the
    default continues the existing log's monotone seq (``--resume``).

    ``max_bytes`` (CLI ``--events-max-mb``) caps the live file: when
    an append pushes past the cap the file rotates to
    ``events.jsonl.1`` (replacing any previous generation) and a
    fresh live file continues the SAME monotone seq, so long
    campaigns hold at most two generations on disk while cursors and
    ``--resume`` anchors stay valid.  0 = unbounded (default).
    """

    def __init__(self, path: str, time_fn=time.time,
                 fresh: bool = False, max_bytes: int = 0):
        self.path = _resolve_path(path)
        self._time = time_fn
        self._fh = None
        self.max_bytes = int(max_bytes)
        self.rotations = 0
        try:
            ensure_dir(os.path.dirname(self.path) or ".")
        except OSError as e:
            WARNING_MSG("event log dir unavailable: %s", e)
        if fresh:
            try:
                open(self.path, "w").close()
            except OSError as e:
                WARNING_MSG("event log truncate failed: %s", e)
            # a stale rotated generation from a PREVIOUS campaign
            # must not leak into this timeline's readers
            try:
                os.unlink(self.path + ROTATED_SUFFIX)
            except OSError:
                pass
            self._seq = 0
        else:
            # monotone seq across --resume: continue past the
            # existing log
            self._seq = last_event_seq(self.path) + 1
        #: last emission wall time per type (the sink sources AFL's
        #: last_path / last_crash / last_hang from these)
        self.last_times: Dict[str, float] = {}

    @property
    def next_seq(self) -> int:
        return self._seq

    def ensure_seq_at_least(self, seq: int) -> None:
        """Raise the next seq to at least ``seq`` — the resume path
        floors the stream at the checkpoint's high-water so a torn or
        truncated log can never make seq regress for cursor
        consumers."""
        self._seq = max(self._seq, int(seq))

    def emit(self, etype: str, **fields) -> Dict[str, Any]:
        """Append one record; returns it (even when the write failed —
        in-process consumers still see the event)."""
        rec: Dict[str, Any] = {"v": SCHEMA_VERSION, "seq": self._seq,
                               "t": self._time(), "type": etype}
        rec.update(fields)
        self._seq += 1
        self.last_times[etype] = rec["t"]
        try:
            # chaos seam: the event append is a persistence path too
            # (ENOSPC degrades to the warning below; kill mode is the
            # mid-append power cut readers must heal from)
            chaos_point("event_append", path=self.path)
            if self._fh is None:
                self._fh = open(self.path, "a")
                # a previous process killed mid-append leaves a torn
                # tail with no newline; appending straight onto it
                # would weld two records into one unreadable line
                if self._fh.tell() > 0:
                    with open(self.path, "rb") as rf:
                        rf.seek(-1, os.SEEK_END)
                        if rf.read(1) != b"\n":
                            self._fh.write("\n")
            # one write() per record: a kill tears at most the tail
            # line, which every reader skips.  default=str absorbs
            # non-JSON field types (numpy scalars, bytes) — the
            # emitting tier must never be able to kill the campaign
            self._fh.write(json.dumps(rec, default=str) + "\n")
            self._fh.flush()
            if self.max_bytes > 0 and self._fh.tell() >= self.max_bytes:
                self._rotate()
        except (OSError, TypeError, ValueError) as e:
            WARNING_MSG("event log append failed: %s", e)
        return rec

    def _rotate(self) -> None:
        """Roll the live file to ``events.jsonl.1`` (previous
        generation replaced — the cap bounds TOTAL footprint at
        ~2x max_bytes); the next emit reopens a fresh live file and
        seq continues monotone from memory."""
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        try:
            os.replace(self.path, self.path + ROTATED_SUFFIX)
            self.rotations += 1
        except OSError as e:
            # a persistently failing replace (.1 is a directory,
            # permissions) must not re-warn and re-attempt on every
            # subsequent emit — rotation turns itself off
            self.max_bytes = 0
            WARNING_MSG("event log rotation failed (%s); rotation "
                        "disabled, log grows unbounded", e)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
