"""Process-local metrics registry — the campaign's single source of
truth for runtime counters.

Four series kinds, all O(1) per record call (no locks on the hot
path; one fuzzing loop owns the registry and the sink reads
snapshots, which in CPython are consistent dict reads):

  * counters    — monotone totals (execs, crashes, bytes written)
  * gauges      — last-value samples (corpus size, pipeline depth)
  * EMA rates   — exponentially-decayed events/second with an
                  explicit observation weight, so shard/worker rates
                  merge as a weighted mean
  * histograms  — fixed log2 buckets over seconds (stage latencies)

``StageTimer`` times the loop's phases (mutate-dispatch, execute,
host-transfer, triage-reduce, corpus-feedback, fs-write) from the
HOST's perspective: it timestamps around the existing lazy-array
materialization boundaries (``np.asarray`` on a prefetched device
array) and never calls ``block_until_ready``, so the superbatch path
stays fully async — "execute" measures dispatch cost and
"host_transfer" measures how long the host actually waited for a
transfer that was prefetched batches ago, which is the number that
matters for pipeline tuning (PTrix-style stage utilization).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

#: log2 bucket upper bounds in seconds for stage histograms:
#: 1us .. ~65s, doubling; the last bucket is +inf
HIST_BUCKETS: List[float] = [1e-6 * (2 ** i) for i in range(27)]

#: canonical loop stage names, in pipeline order (glossary in
#: docs/OBSERVABILITY.md).  The port's loop also times ``telemetry``
#: (rates, gauges, folding the device spans, the stats flush) and
#: ``checkpoint`` (the campaign checkpoint between dispatches); they
#: stay out of this tuple, so that the stage split and kb-stats read
#: as the JAX package's, and show as their own counters
STAGES = ("mutate", "execute", "host_transfer", "triage",
          "corpus_feedback", "fs_write", "learn")


class EmaRate:
    """Events/second EMA over a ``tau``-second horizon.

    ``add(n)`` is O(1): it decays the running rate by the elapsed
    wall-clock gap and folds the new observation in.  ``weight``
    grows toward 1 with observed time, so a rate that has only seen
    half a horizon merges at half strength (a rate-weighted mean)
    instead of dominating a long-lived peer.
    """

    __slots__ = ("tau", "_rate", "_weight", "_last", "_time")

    def __init__(self, tau: float = 30.0, time_fn=time.monotonic):
        self.tau = float(tau)
        self._rate = 0.0
        self._weight = 0.0
        self._last: Optional[float] = None
        self._time = time_fn

    def add(self, n: float) -> None:
        now = self._time()
        if self._last is None:
            self._last = now
            return                      # first sample only anchors t0
        dt = now - self._last
        self._last = now
        if dt <= 0:
            return
        alpha = min(dt / self.tau, 1.0)
        self._rate += alpha * (n / dt - self._rate)
        self._weight += alpha * (1.0 - self._weight)

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def weight(self) -> float:
        return self._weight

    def as_dict(self) -> Dict[str, float]:
        return {"rate": self._rate, "weight": self._weight}


#: quantiles estimated from bucket counts (snapshot keys p50/p90/p99)
PERCENTILES = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))


def _quantile_from_counts(counts, total: int, q: float) -> float:
    """One q-quantile estimate over per-bucket counts against the
    static HIST_BUCKETS edges: linear interpolation inside the
    bucket, overflow bucket clamps to the last finite edge.  The
    single implementation behind ``percentiles_from_counts`` and
    ``Histogram.percentile`` — they must never diverge."""
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            if i >= len(HIST_BUCKETS):
                return HIST_BUCKETS[-1]          # overflow bucket
            lo = HIST_BUCKETS[i - 1] if i > 0 else 0.0
            frac = (target - (cum - c)) / c if c else 1.0
            return lo + frac * (HIST_BUCKETS[i] - lo)
    return HIST_BUCKETS[-1]


def percentiles_from_counts(counts) -> Dict[str, float]:
    """p50/p90/p99 estimates from per-bucket counts.  Shared by
    ``Histogram.as_dict`` and the JAX package's fleet merge, so merged
    fleet histograms re-derive their quantiles from the merged
    counts instead of averaging per-worker quantiles (which would be
    wrong and non-associative)."""
    counts = [int(c) for c in counts]
    total = sum(counts)
    if total <= 0:
        return {}
    return {key: _quantile_from_counts(counts, total, q)
            for q, key in PERCENTILES}


class Histogram:
    """Fixed-bucket histogram: ``buckets[i]`` counts observations
    <= HIST_BUCKETS[i]; the final slot is the overflow bucket."""

    __slots__ = ("counts", "total", "sum")

    def __init__(self):
        self.counts = [0] * (len(HIST_BUCKETS) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        lo, hi = 0, len(HIST_BUCKETS)
        while lo < hi:                  # bisect over static edges
            mid = (lo + hi) // 2
            if v <= HIST_BUCKETS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.total += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (0 < q <= 1) from the buckets."""
        if self.total <= 0:
            return 0.0
        return _quantile_from_counts(self.counts, self.total, q)

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"counts": list(self.counts),
                                "total": self.total, "sum": self.sum}
        d.update(percentiles_from_counts(self.counts))
        return d


class MetricsRegistry:
    """Named series, created on first touch; snapshot() is the wire
    format every consumer (sink, fleet merge, manager, TUI) reads."""

    def __init__(self, time_fn=time.time):
        self._time = time_fn
        self.start_time = time_fn()
        self._run_start: Optional[float] = None
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.rates: Dict[str, EmaRate] = {}
        self.hists: Dict[str, Histogram] = {}

    # -- record calls (hot path) ---------------------------------------

    def count(self, name: str, n: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def rate(self, name: str, n: float, tau: float = 30.0) -> None:
        r = self.rates.get(name)
        if r is None:
            r = self.rates[name] = EmaRate(tau)
        r.add(n)

    def observe(self, name: str, seconds: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(seconds)
        # stage time split wants totals, not just distributions
        self.count(name + "_seconds", seconds)

    # -- views ----------------------------------------------------------

    def elapsed(self) -> float:
        """Lifetime wall-clock: the ONE definition of campaign age
        (the CLI, the loop and the stats files all read it)."""
        return max(self._time() - self.start_time, 1e-9)

    # -- run windows: rates divide by ACTIVE fuzzing time, so warm-up
    # gaps between run() calls (bench does this) don't dilute them --

    def run_started(self) -> None:
        self._run_start = self._time()

    def run_ended(self) -> None:
        if self._run_start is not None:
            self.count("run_seconds", self._time() - self._run_start)
            self._run_start = None

    def active_seconds(self) -> float:
        s = self.counters.get("run_seconds", 0.0)
        if self._run_start is not None:
            s += self._time() - self._run_start
        return s

    def execs_per_sec(self) -> float:
        """Lifetime rate over active run time (falls back to campaign
        age when the owner never marks run windows)."""
        e = self.active_seconds() or self.elapsed()
        return self.counters.get("execs", 0.0) / e

    def execs_per_sec_ema(self) -> float:
        r = self.rates.get("execs")
        return r.rate if r is not None else 0.0

    def stage_split(self) -> Dict[str, float]:
        """{stage: fraction of accounted stage time}, for the bench
        summary line and the TUI bar."""
        totals = {s: self.counters.get(s + "_seconds", 0.0)
                  for s in STAGES}
        acc = sum(totals.values())
        if acc <= 0:
            return {}
        return {s: t / acc for s, t in totals.items() if t > 0}

    def snapshot(self) -> Dict[str, object]:
        return {
            "t": self._time(),
            "start_time": self.start_time,
            "elapsed": self.elapsed(),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "rates": {k: v.as_dict() for k, v in self.rates.items()},
            "hists": {k: v.as_dict() for k, v in self.hists.items()},
            "derived": {
                "execs_per_sec": self.execs_per_sec(),
                "execs_per_sec_ema": self.execs_per_sec_ema(),
            },
        }


class _Span:
    __slots__ = ("timer", "stage", "_t0", "_lane", "_child")

    def __init__(self, timer: "StageTimer", stage: str):
        self.timer = timer
        self.stage = stage
        self._t0 = 0.0
        self._lane = 0
        self._child = 0.0

    def __enter__(self) -> "_Span":
        tr = self.timer.tracer
        if tr is not None:
            # pin the lane at entry: the loop may retarget the
            # recorder's current lane mid-span (triaging another
            # batch inside a corpus_feedback span), and a B/E pair
            # split across lanes would corrupt both lanes' stacks
            self._lane = tr.lane
            tr.begin(self.stage)
        self.timer._stack.append(self)
        self._t0 = self.timer.clock()
        return self

    def __exit__(self, *exc) -> None:
        timer = self.timer
        d = timer.clock() - self._t0
        timer.reg.observe(self.stage, d)
        stack = timer._stack
        if stack and stack[-1] is self:
            stack.pop()
        else:                           # left out of order
            stack.remove(self)
        if stack:
            stack[-1]._child += d
        # self time: the span less the spans nested in it, so that the
        # self times of every stage partition the host's timed time
        timer.reg.count(self.stage + "_self_seconds", d - self._child)
        if timer.tracer is not None:
            timer.tracer.end(self.stage, lane=self._lane)


class StageTimer:
    """Context-manager stopwatch over a registry's stage series.

    ``with timer("triage"): ...`` records one histogram observation
    plus the running ``<stage>_seconds`` counter.  Spans nest (an
    fs_write inside a triage span double-counts wall time by design:
    the split reports where the host spent attention, not a
    partition); each span also adds its self time, its duration less
    the spans nested in it, to ``<stage>_self_seconds``, and those do
    partition: their sum is the time inside any stage.
    perf_counter is ~40ns per call; at one timing per batch (1k-64k
    execs) the overhead is unmeasurable.  No device syncs: callers
    time around materialization points that already exist.

    When a ``TraceRecorder`` is attached (``--trace``), every timed
    stage also records a begin/end span on the recorder's CURRENT
    lane — the fuzzing loop points that lane at the in-flight batch's
    pipeline slot, so the one instrumentation site feeds both the
    aggregate split and the flight-recorder timeline.
    """

    __slots__ = ("reg", "tracer", "clock", "_stack")

    def __init__(self, registry: MetricsRegistry, tracer=None,
                 clock=time.perf_counter):
        self.reg = registry
        self.tracer = tracer
        self.clock = clock
        #: the spans open now, outermost first
        self._stack: List[_Span] = []

    def __call__(self, stage: str) -> _Span:
        return _Span(self, stage)
