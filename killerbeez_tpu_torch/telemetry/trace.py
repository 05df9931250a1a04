"""Pipeline trace recorder — the flight recorder's span tier.

The metrics registry answers "how much"; this module answers "WHEN".  A
``TraceRecorder`` is a bounded ring buffer of begin/end span and
instant events over ``perf_counter`` timestamps, cheap enough to sit
on the fuzzing loop's hot path (one tuple build + one list store per
record, no I/O, no locks — ~O(100ns)) and exported on demand as
Chrome trace-event JSON that Perfetto / ``chrome://tracing`` render
directly.  PTrix (arxiv 1905.10499) is the model: throughput problems
become debuggable when you can SEE per-batch pipeline occupancy, not
just aggregate counters.

Complete events (``complete``, Chrome ph X) carry both ends, so they
can be recorded after the fact: the device spans (device.py) land on a
``device`` lane once the card has passed them, on the same clock.

Lane model: each event carries a ``lane`` (the Chrome ``tid``).  The
fuzzing loop assigns every in-flight batch one of ``PIPELINE_DEPTH``
pipeline lanes, so its mutate → dispatch → in-flight → transfer →
triage spans stack into one row per pipeline slot; cold stages
(crack, corpus sync, mesh shards) get named lanes of their own.
Lanes are registered by name (``lane_id("crack")``) and exported as
``thread_name`` metadata so the viewer labels the rows.

Ring discipline: when the buffer wraps, the OLDEST events are
overwritten — a long campaign keeps its most recent window, like a
hardware trace buffer.  Export rebalances: an ``E`` whose ``B`` was
overwritten is dropped, and spans still open at export time (a
mid-span shutdown) get synthetic closes, so the emitted JSON always
has balanced B/E pairs.

Tracing is OFF by default (``--trace [max_spans]`` / ``trace=``);
when off the loop never touches this module.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.logging import WARNING_MSG

#: default ring capacity in EVENTS (a span is two events); at ~6
#: events per batch this holds the last ~10k batches
DEFAULT_MAX_EVENTS = 1 << 16


class _LaneSpan:
    """Context manager: record one span, optionally on a named lane,
    restoring the recorder's current lane on exit (cold-path helper —
    the hot loop calls begin/end directly)."""

    __slots__ = ("tr", "name", "lane", "args", "_prev")

    def __init__(self, tr: "TraceRecorder", name: str,
                 lane: Optional[int], args: Optional[Dict]):
        self.tr = tr
        self.name = name
        self.lane = lane
        self.args = args
        self._prev = 0

    def __enter__(self) -> "_LaneSpan":
        self._prev = self.tr.lane
        if self.lane is not None:
            self.tr.lane = self.lane
        self.tr.begin(self.name, args=self.args)
        return self

    def __exit__(self, *exc) -> None:
        # end on the lane the span BEGAN on (code inside may have
        # retargeted the recorder), then restore the caller's lane
        self.tr.end(self.name,
                    lane=self.lane if self.lane is not None
                    else self._prev)
        self.tr.lane = self._prev


class TraceRecorder:
    """Bounded ring of trace events with Chrome trace-event export."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS,
                 clock=time.perf_counter, wall=time.time):
        self.max_events = max(int(max_events), 4)
        self._buf: List[Optional[tuple]] = [None] * self.max_events
        self._n = 0                      # events ever recorded
        self._clock = clock
        self._t0 = clock()
        #: wall-clock anchor for overlaying events.jsonl (wall times)
        #: onto the perf_counter span timeline
        self.wall_t0 = wall()
        #: current lane (Chrome tid); the loop points this at the
        #: in-flight batch's pipeline slot before dispatch/triage
        self.lane = 0
        self._lane_names: Dict[str, int] = {}
        self._next_lane = 64             # named lanes above the
        #                                  pipeline-slot range

    # -- hot path -------------------------------------------------------

    def begin(self, name: str, lane: Optional[int] = None,
              args: Optional[Dict[str, Any]] = None) -> None:
        self._buf[self._n % self.max_events] = (
            "B", name, self.lane if lane is None else lane,
            self._clock(), args, None)
        self._n += 1

    def end(self, name: str, lane: Optional[int] = None) -> None:
        self._buf[self._n % self.max_events] = (
            "E", name, self.lane if lane is None else lane,
            self._clock(), None, None)
        self._n += 1

    def instant(self, name: str, lane: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None,
                t: Optional[float] = None) -> None:
        """A point event, at ``t`` (this recorder's clock) or now."""
        self._buf[self._n % self.max_events] = (
            "i", name, self.lane if lane is None else lane,
            self._clock() if t is None else t, args, None)
        self._n += 1

    def complete(self, name: str, t0: float, t1: float,
                 lane: int) -> None:
        """A span with explicit start and end times on this recorder's
        clock (Chrome ph X), recorded after the fact: the device spans
        (telemetry/device.py) fold in once the card has passed them."""
        self._buf[self._n % self.max_events] = (
            "X", name, lane, t0, None, t1)
        self._n += 1

    # async pairs (Chrome ph b/e): for operations that span OTHER
    # spans' boundaries — a batch's in-flight window opens at dispatch
    # and closes at triage, with arbitrary sync spans beginning and
    # ending in between on the same lane.  Sync B/E pairs are matched
    # by per-lane STACK discipline, which such an operation would
    # corrupt; async pairs match by (lane, name, id) instead.

    def async_begin(self, name: str, aid: int,
                    lane: Optional[int] = None,
                    args: Optional[Dict[str, Any]] = None) -> None:
        self._buf[self._n % self.max_events] = (
            "b", name, self.lane if lane is None else lane,
            self._clock(), args, aid)
        self._n += 1

    def async_end(self, name: str, aid: int,
                  lane: Optional[int] = None) -> None:
        self._buf[self._n % self.max_events] = (
            "e", name, self.lane if lane is None else lane,
            self._clock(), None, aid)
        self._n += 1

    # -- lanes ----------------------------------------------------------

    def lane_id(self, name: str) -> int:
        """Stable tid for a named lane (registered on first use)."""
        tid = self._lane_names.get(name)
        if tid is None:
            tid = self._lane_names[name] = self._next_lane
            self._next_lane += 1
        return tid

    def name_lane(self, tid: int, name: str) -> None:
        """Label an existing numeric lane (pipeline slots)."""
        self._lane_names[name] = int(tid)

    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        """Events lost to ring wrap-around."""
        return max(0, self._n - self.max_events)

    # -- export ---------------------------------------------------------

    def _ordered(self) -> List[tuple]:
        """Buffer contents oldest-first."""
        if self._n <= self.max_events:
            return [e for e in self._buf[:self._n]]
        i = self._n % self.max_events
        return self._buf[i:] + self._buf[:i]

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object with BALANCED pairs: orphan
        ends (begin lost to ring wrap) are dropped, spans still open
        (mid-span shutdown) get a synthetic close at the last observed
        timestamp.  Sync B/E pairs balance per-lane by stack; async
        b/e pairs balance by (lane, name, id)."""
        events: List[Dict[str, Any]] = []
        pid = os.getpid()
        open_stacks: Dict[int, List[int]] = {}   # tid -> [event idx]
        open_async: Dict[tuple, int] = {}        # (tid,name,id) -> idx
        last_ts = 0.0
        for ev in self._ordered():
            ph, name, tid, t, args, aid = ev
            ts = (t - self._t0) * 1e6            # us, trace-relative
            last_ts = max(last_ts, ts)
            if ph == "E":
                stack = open_stacks.get(tid)
                if not stack:
                    continue                     # begin wrapped away
                stack.pop()
                events.append({"ph": "E", "name": name, "pid": pid,
                               "tid": tid, "ts": round(ts, 3)})
                continue
            if ph == "e":
                if open_async.pop((tid, name, aid), None) is None:
                    continue                     # begin wrapped away
                events.append({"ph": "e", "cat": "pipeline",
                               "id": aid, "name": name, "pid": pid,
                               "tid": tid, "ts": round(ts, 3)})
                continue
            rec = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                   "ts": round(ts, 3)}
            if ph == "X":
                rec["dur"] = round((aid - t) * 1e6, 3)
                events.append(rec)
                continue
            if args:
                rec["args"] = args
            if ph == "B":
                open_stacks.setdefault(tid, []).append(len(events))
            elif ph == "b":
                rec["cat"] = "pipeline"
                rec["id"] = aid
                open_async[(tid, name, aid)] = len(events)
            elif ph == "i":
                rec["s"] = "t"                   # thread-scoped mark
            events.append(rec)
        # mid-span shutdown: close whatever is still open, innermost
        # first, so every begin has an end
        for tid, stack in open_stacks.items():
            for idx in reversed(stack):
                b = events[idx]
                events.append({"ph": "E", "name": b["name"],
                               "pid": pid, "tid": tid,
                               "ts": round(last_ts, 3)})
        for (tid, name, aid) in open_async:
            events.append({"ph": "e", "cat": "pipeline", "id": aid,
                           "name": name, "pid": pid, "tid": tid,
                           "ts": round(last_ts, 3)})
        for name, tid in sorted(self._lane_names.items(),
                                key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": name}})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "killerbeez-tpu flight recorder",
                #: wall time of trace ts==0 — kb-timeline uses this to
                #: place events.jsonl records on the span timeline
                "wall_t0": self.wall_t0,
                "events_recorded": self._n,
                "events_dropped": self.dropped,
            },
        }

    def export(self, path: str) -> bool:
        """Atomically write the Chrome trace JSON; degrades to a
        warning (the sink's discipline — observability never kills a
        campaign)."""
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                # default=str absorbs non-JSON span/instant args
                # (numpy scalars, bytes): export runs in run()'s
                # finally and must never mask the run's real outcome
                json.dump(self.to_chrome(), f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return True
        except (OSError, TypeError, ValueError) as e:
            WARNING_MSG("trace export to %s failed: %s", path, e)
            return False

    # -- cold-path sugar ------------------------------------------------

    def span(self, name: str, lane: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None) -> _LaneSpan:
        """``with tr.span("crack", lane="crack"): ...`` — records one
        span on a named lane and restores the previous lane."""
        tid = self.lane_id(lane) if lane is not None else None
        return _LaneSpan(self, name, tid, args)


def load_chrome_trace(path: str) -> Optional[Dict[str, Any]]:
    """Read a trace.json back (kb-timeline / tests)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
