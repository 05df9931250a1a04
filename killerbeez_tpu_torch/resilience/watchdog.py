"""Dispatch watchdog — a deadline on every blocking device wait.

The only host-visible symptom of a wedged card is a blocking wait
that never returns: here, the CUDA event synchronize behind a pipeline
batch's host copy (``fuzzer/loop.py`` ``_HostCopy.materialize``).
Python cannot interrupt that wait — the GIL is released inside the
runtime, but no exception can be delivered into it — so the only
honest escalation is: record what was in flight, then kill the process
and let a supervisor restart into ``--resume``.

Mechanics: the fuzzing loop wraps each blocking region in
``watchdog.guard(stage)``; a monitor thread checks the armed deadline
and, when it expires, (1) emits a ``watchdog_stall`` campaign event,
(2) calls the loop's dump hook (in-flight pipeline lane state +
flight-recorder export — the post-mortem artifact), then (3) runs the
escalation action, by default ``os._exit(WATCHDOG_EXIT_CODE)`` so the
supervisor classifies the exit as a watchdog kill.

The deadline scales with the measured batch time so slow targets
don't false-positive and fast ones don't wait minutes: it is
``multiplier x EMA batch seconds`` clamped to ``[min_deadline,
max_deadline]``.  EMA batch seconds prefers the telemetry registry's
``execs`` EMA rate (batch_size / rate — the same number kb-stats
shows), falling back to the watchdog's own EMA of observed guarded
waits until the registry has weight.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from . import WATCHDOG_EXIT_CODE
from ..utils.logging import CRITICAL_MSG, WARNING_MSG


class DispatchWatchdog:
    """Deadline monitor for one fuzzing loop's blocking device waits.

    ``guard(stage)`` is the loop-facing API::

        with watchdog.guard("host_transfer"):
            arr = np.asarray(packed)        # may block on the device

    ``note_batch(n)`` tells the deadline model the loop's batch size
    (needed to turn the registry's execs/sec EMA into seconds/batch).
    """

    #: monitor poll cadence; the deadline guarantee is
    #: ``deadline + _TICK`` worst case, well inside the 2x bound the
    #: chaos suite pins
    _TICK = 0.25

    def __init__(self, registry=None, multiplier: float = 8.0,
                 min_deadline: float = 5.0,
                 max_deadline: float = 120.0,
                 telemetry=None,
                 dump_fn: Optional[Callable] = None,
                 action: Optional[Callable] = None):
        self.registry = registry
        self.multiplier = float(multiplier)
        self.min_deadline = float(min_deadline)
        self.max_deadline = max(float(max_deadline), self.min_deadline)
        self.telemetry = telemetry
        self.dump_fn = dump_fn
        self.action = action if action is not None \
            else (lambda: os._exit(WATCHDOG_EXIT_CODE))
        self.batch_size = 0
        self.stalls = 0
        self._ema_batch_s = 0.0         # fallback when registry is cold
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._armed_deadline = 0.0
        self._armed_stage = ""
        self._thread: Optional[threading.Thread] = None
        self._halt = threading.Event()

    # -- deadline model --------------------------------------------------

    def note_batch(self, n: int) -> None:
        self.batch_size = int(n)

    def ema_batch_seconds(self) -> float:
        """Best estimate of one batch's wall time: the registry's
        execs EMA (authoritative once warm), else the watchdog's own
        EMA of guarded waits."""
        reg = self.registry
        if reg is not None and self.batch_size > 0:
            r = reg.rates.get("execs")
            if r is not None and r.weight > 0.1 and r.rate > 0:
                return self.batch_size / r.rate
        return self._ema_batch_s

    def deadline(self) -> float:
        est = self.ema_batch_seconds()
        if est <= 0:
            # cold start: the first dispatch includes the kernel
            # build, which dwarfs any steady-state batch — grant the ceiling
            # until a real batch time has been observed (a genuinely
            # wedged FIRST dispatch still dies, just at max_deadline)
            return self.max_deadline
        return min(max(self.multiplier * est, self.min_deadline),
                   self.max_deadline)

    # -- arming ----------------------------------------------------------

    def guard(self, stage: str) -> "_Guard":
        return _Guard(self, stage)

    def _arm(self, stage: str) -> None:
        if self._thread is None or not self._thread.is_alive():
            # (re)start the monitor: stop() at run end parks it, and
            # repeated run() calls (bench loops) re-arm cleanly
            self._halt = threading.Event()
            self._thread = threading.Thread(
                target=self._monitor, name="kbz-watchdog", daemon=True)
            self._thread.start()
        with self._lock:
            self._armed_stage = stage
            self._armed_deadline = self.deadline()
            self._armed_at = time.monotonic()

    def _disarm(self) -> None:
        with self._lock:
            t0 = self._armed_at
            self._armed_at = None
        if t0 is not None:
            # the guarded wait IS (an upper bound on) the batch time;
            # a 0.2 alpha tracks regime changes within ~5 batches
            waited = time.monotonic() - t0
            self._ema_batch_s += 0.2 * (waited - self._ema_batch_s)

    def stop(self) -> None:
        self._halt.set()

    # -- the monitor -----------------------------------------------------

    def _monitor(self) -> None:
        while not self._halt.wait(self._TICK):
            with self._lock:
                t0 = self._armed_at
                deadline = self._armed_deadline
                stage = self._armed_stage
            if t0 is None:
                continue
            waited = time.monotonic() - t0
            if waited < deadline:
                continue
            self._stall(stage, waited, deadline)
            return                      # one stall ends the process

    def _stall(self, stage: str, waited: float,
               deadline: float) -> None:
        """Deadline blown: record, dump, escalate.  Runs on the
        monitor thread — the main thread is the thing that is stuck."""
        self.stalls += 1
        CRITICAL_MSG(
            "watchdog: %s stalled %.1fs (deadline %.1fs, ema batch "
            "%.3fs) — dumping in-flight state and escalating",
            stage, waited, deadline, self.ema_batch_seconds())
        if self.telemetry is not None:
            try:
                self.telemetry.event(
                    "watchdog_stall", stage=stage,
                    waited_s=round(waited, 3),
                    deadline_s=round(deadline, 3),
                    batch_size=int(self.batch_size))
            except Exception as e:
                WARNING_MSG("watchdog: stall event failed: %s", e)
        if self.dump_fn is not None:
            try:
                self.dump_fn(stage, waited, deadline)
            except Exception as e:
                WARNING_MSG("watchdog: state dump failed: %s", e)
        self.action()


class _Guard:
    __slots__ = ("wd", "stage")

    def __init__(self, wd: DispatchWatchdog, stage: str):
        self.wd = wd
        self.stage = stage

    def __enter__(self) -> "_Guard":
        self.wd._arm(self.stage)
        return self

    def __exit__(self, *exc) -> None:
        self.wd._disarm()
