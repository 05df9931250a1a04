"""Device spans: the card's time at the port's own layer boundaries,
on the host's clock.

The stage timers (metrics.py) see the host; this recorder sees the
card.  It records CUDA timing events, drawn from a reused pool, on the
dispatch stream where the port moves from one layer to the next:

  * ``begin`` and ``end`` around a dispatch's driver call, the end
    with the host's ``perf_counter`` as the call returned;
  * per batch (per generation under ``-G``) a ``batch`` start mark and
    one ``mark(layer)`` at the end of each layer: ``kernels`` (the
    fused kernel and its two-phase glue), ``triage`` (``_judge``'s
    torch ops), ``report`` (verdict packing and the compaction, or the
    findings ring's append and admission).

``collect`` folds every dispatch whose end mark the card has passed
into registry counters, using only ``query()`` on that mark: it never
waits.  With a ``TraceRecorder`` it also writes each interval onto a
``device`` lane, under the host's spans of the same moments.

One ``anchor`` per ``run()`` maps the card's clock onto the host's: it
drains the stream and records an anchor event on the idle stream
between two reads of ``perf_counter``, so a later event E happened at
``t_anchor + anchor.elapsed_time(E) / 1e3`` host seconds.  With
``--profile-device`` the capture starts before the anchor, a marker
kernel (``spin_kernel``) runs right after it, and the ``device`` lane
gets a ``clock_sync`` instant at the host time the card passed the
marker: shift ``device_trace/trace.json`` by the marker's start less
the instant's ``ts``, and it lies on ``trace.json``'s clock.

Counters (every name ends in ``_seconds``):

  ``dev_<layer>_seconds``    the layer's device seconds, summed over batches
  ``dev_dispatch_seconds``   each dispatch's begin mark to its end mark
  ``dev_between_seconds``    the previous dispatch's end mark to this
                             one's begin mark: stream time with no
                             dispatch on it
  ``dispatch_lead_seconds``  the host time at which the card reached a
                             dispatch's end mark, less the host time at
                             which its enqueue returned: well above 0
                             when the card sets the pace, near 0 when
                             the host does

The recorder is installed only on CUDA campaigns; where it is not,
each site costs one ``is None`` test.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional


#: rounds of the anchor's clock reads; the tightest is kept
ANCHOR_ROUNDS = 8


def _cuda_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


class _Dispatch:
    __slots__ = ("begin", "groups", "end", "t_end")

    def __init__(self, begin):
        self.begin = begin
        #: per batch: [(mark name, event), ...], the first "batch"
        self.groups: List[list] = []
        self.end = None
        self.t_end = 0.0


class DeviceSpans:
    """Pooled CUDA timing events at layer boundaries, folded into a
    registry's counters once the card has passed them."""

    def __init__(self, registry, tracer=None,
                 new_event: Callable = _cuda_event,
                 clock: Callable[[], float] = time.perf_counter):
        self.reg = registry
        self.tracer = tracer
        self._new_event = new_event
        self._clock = clock
        self._pool: list = []
        self._t_anchor = 0.0
        self._anchor = None
        self._open: Optional[_Dispatch] = None
        #: enqueued dispatches not folded yet, oldest first
        self._queued: deque = deque()
        #: the last folded dispatch's end mark (for the gap before the
        #: next one)
        self._prev_end = None

    def _record(self):
        ev = self._pool.pop() if self._pool else self._new_event()
        ev.record()
        return ev

    # -- the clock --------------------------------------------------------

    def anchor(self, marker: Optional[Callable[[], None]] = None) -> float:
        """Drain the stream (folding what was in flight) and take the
        anchor on the idle stream: in each of ``ANCHOR_ROUNDS`` rounds
        the host reads its clock, records an event, waits for it and
        reads its clock again.  The card stamped the event between the
        two reads, so the round with the tightest pair is kept and its
        event placed at their middle (a card waking from idle stamps an
        event hundreds of microseconds after the record call).
        ``marker``, when given, then launches a kernel and records an
        event right behind it; the flight recorder gets a ``clock_sync``
        instant at that event's host time, for a profiler's capture of
        the marker to align by.  Waits for the card: call it in set-up.
        Returns the anchor's host time."""
        fence = self._record()
        fence.synchronize()
        self.collect()
        self._pool.append(fence)
        if self._prev_end is not None:  # no gap across run() calls
            self._pool.append(self._prev_end)
            self._prev_end = None
        best = None
        for _ in range(ANCHOR_ROUNDS):
            t0 = self._clock()
            ev = self._record()
            ev.synchronize()
            t1 = self._clock()
            if best is None or t1 - t0 < best[1]:
                if best is not None:
                    self._pool.append(best[2])
                best = (t0 + (t1 - t0) / 2, t1 - t0, ev)
            else:
                self._pool.append(ev)
        t, _, ev = best
        if self._anchor is not None:
            self._pool.append(self._anchor)
        self._t_anchor, self._anchor = t, ev
        if marker is not None:
            marker()
            m = self._record()
            m.synchronize()
            if self.tracer is not None:
                self.tracer.instant("clock_sync",
                                    lane=self.tracer.lane_id("device"),
                                    args={"marker": "spin_kernel"},
                                    t=self.host_time(m))
            self._pool.append(m)
        return t

    def host_time(self, ev) -> float:
        """The host time at which the card passed the (completed)
        event ``ev``."""
        return self._t_anchor + self._anchor.elapsed_time(ev) / 1e3

    # -- marks (the hot path) ---------------------------------------------

    def begin(self) -> None:
        """A dispatch's first mark, just before the driver call (none
        before the first anchor)."""
        if self._anchor is not None:
            self._open = _Dispatch(self._record())

    def batch(self) -> None:
        """A batch's (a generation's) first mark."""
        d = self._open
        if d is not None:
            d.groups.append([("batch", self._record())])

    def mark(self, layer: str) -> None:
        """The end of ``layer`` in the current batch: its interval runs
        from the batch's previous mark to this one."""
        d = self._open
        if d is not None and d.groups:
            d.groups[-1].append((layer, self._record()))

    def end(self) -> None:
        """A dispatch's last mark, as the driver call returns."""
        d = self._open
        if d is None:
            return
        d.t_end = self._clock()
        d.end = self._record()
        self._open = None
        self._queued.append(d)

    # -- folding ----------------------------------------------------------

    def collect(self) -> None:
        """Fold every dispatch the card has finished, oldest first;
        stops at the first one still running (never waits)."""
        while self._queued and self._queued[0].end.query():
            self._fold(self._queued.popleft())

    def _fold(self, d: _Dispatch) -> None:
        reg = self.reg
        t0 = self.host_time(d.begin)
        span = d.begin.elapsed_time(d.end) / 1e3
        reg.count("dev_dispatch_seconds", span)
        reg.count("dispatch_lead_seconds", t0 + span - d.t_end)
        if self._prev_end is not None:
            reg.count("dev_between_seconds",
                      self._prev_end.elapsed_time(d.begin) / 1e3)
            self._pool.append(self._prev_end)
        tr = self.tracer
        lane = tr.lane_id("device") if tr is not None else 0
        for group in d.groups:
            at = [t0 + d.begin.elapsed_time(ev) / 1e3 for _, ev in group]
            for (layer, _), a, b in zip(group[1:], at, at[1:]):
                reg.count("dev_" + layer + "_seconds", b - a)
                if tr is not None:
                    tr.complete(layer, a, b, lane)
            self._pool.extend(ev for _, ev in group)
        if tr is not None:
            tr.complete("dispatch", t0, t0 + span, lane)
        self._pool.append(d.begin)
        self._prev_end = d.end
