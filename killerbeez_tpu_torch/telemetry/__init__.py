"""Campaign observability subsystem.

The reference fuzzer's only runtime signal is log lines plus a final
stats struct (fuzzer/main.c prints iteration counts at exit); this
package gives the port the AFL ecosystem's signals instead: a
process-local metrics registry with stage timers (metrics.py), the
card's own time at the port's layer boundaries on CUDA campaigns
(device.py), periodic AFL-compatible ``fuzzer_stats`` / ``plot_data`` /
``stats.jsonl`` writers (sink.py), an associative snapshot merge
(aggregate.py) for the (dp, mp) mesh campaign's per-shard fold, the
Prometheus / OpenMetrics text exposition of a snapshot
(openmetrics.py, kb-stats ``--openmetrics``), and
— the flight recorder — a
bounded ring-buffer span tracer with Chrome trace-event export
(trace.py) plus a typed append-only campaign event log (events.py).
All files keep the JAX package's formats.

Typical wiring (the Fuzzer does this itself; no ``output_dir``
disables the file sink and the event log, the registry always runs;
``trace=`` > 0 turns the span recorder on with that many events):

    tl = Telemetry(output_dir="output", trace=65536)
    tl.registry.count("execs", 4096)
    with tl.timer("triage"):
        ...
    tl.event("new_path", md5=digest)
    tl.maybe_flush()
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .aggregate import merge, merge_events, merge_health, merge_two
from .device import DeviceSpans
from .events import (
    EVENT_TYPES, EVENTS_FILE, EventLog, SCHEMA_VERSION,
    TERMINAL_EVENTS, last_event_seq, read_events,
)
from .metrics import (
    EmaRate, Histogram, MetricsRegistry, StageTimer, STAGES,
    percentiles_from_counts,
)
from .openmetrics import render_snapshot as render_openmetrics
from .sink import StatsSink, parse_fuzzer_stats, read_latest_snapshot
from .trace import TraceRecorder, load_chrome_trace

__all__ = [
    "DeviceSpans", "EVENT_TYPES", "EVENTS_FILE", "EmaRate", "EventLog",
    "Histogram", "MetricsRegistry", "SCHEMA_VERSION", "STAGES",
    "StageTimer",
    "StatsSink", "TERMINAL_EVENTS", "Telemetry", "TraceRecorder",
    "last_event_seq", "load_chrome_trace", "merge", "merge_events",
    "merge_health", "merge_two", "parse_fuzzer_stats",
    "percentiles_from_counts", "read_events", "read_latest_snapshot",
    "render_openmetrics",
]

#: event types whose emission stamps an AFL find-recency gauge (the
#: sink writes them as fuzzer_stats last_path/last_crash/last_hang;
#: gauges merge with max, so the fleet view shows the newest find)
_LAST_GAUGES = {"new_path": "last_path", "crash": "last_crash",
                "hang": "last_hang"}


class Telemetry:
    """One campaign's registry + optional file sink, event log and
    span recorder, bundled."""

    def __init__(self, output_dir: Optional[str] = None,
                 interval_s: float = 5.0, trace: int = 0,
                 fresh_events: bool = False,
                 events_max_bytes: int = 0):
        self.registry = MetricsRegistry()
        # trace: the span ring's capacity in events (0 = off)
        self.trace: Optional[TraceRecorder] = (
            TraceRecorder(max_events=trace) if trace > 0 else None)
        self.timer = StageTimer(self.registry, self.trace)
        self.sink = (StatsSink(output_dir, self.registry, interval_s)
                     if output_dir else None)
        # the event log rides the sink: fresh_events truncates an
        # inherited log (a NEW campaign reusing an output dir;
        # --resume continues instead)
        self.events: Optional[EventLog] = (
            EventLog(output_dir, fresh=fresh_events,
                     max_bytes=events_max_bytes)
            if output_dir else None)

    def event(self, etype: str, **fields) -> None:
        """Record one campaign event: appends to events.jsonl (when
        the log is on), stamps the find-recency gauge, and drops an
        instant marker on the span timeline so Perfetto shows finds
        in place."""
        gauge = _LAST_GAUGES.get(etype)
        if gauge is not None:
            self.registry.gauge(gauge, time.time())
        if self.events is not None:
            self.events.emit(etype, **fields)
        if self.trace is not None:
            self.trace.instant(etype, args=fields or None)

    def maybe_flush(self) -> None:
        if self.sink is not None and self.sink.maybe_flush():
            self._note_flush()

    def flush(self) -> None:
        if self.sink is not None:
            self.sink.flush()
            self._note_flush()

    def _note_flush(self) -> None:
        if self.events is not None:
            self.events.emit(
                "flush",
                execs=int(self.registry.counters.get("execs", 0)))

    def export_trace(self, path: str) -> bool:
        """Write the span ring as Chrome trace JSON (no-op when
        tracing is off)."""
        if self.trace is None:
            return False
        return self.trace.export(path)

    def snapshot(self) -> Dict[str, object]:
        return self.registry.snapshot()
