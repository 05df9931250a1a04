"""Window arithmetic on host timestamps: the rate over all the work
and all the time of a window, and the tail of every step in it."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def execs_in_window(stamped: Iterable[Tuple[float, int]], t0: float,
                    t1: float) -> int:
    """Executions stamped (time, executions) in (t0, t1]."""
    return sum(n for t, n in stamped if t0 < t <= t1)


def rate(stamped: Iterable[Tuple[float, int]], t0: float,
         t1: float) -> float:
    """Executions stamped in the window per second of the window."""
    return execs_in_window(stamped, t0, t1) / (t1 - t0)


def step_intervals(step_ends: Sequence[float], t0: float,
                   t1: float) -> List[float]:
    """Seconds from each step's end to the next one's, for every step
    that ended in (t0, t1]; the first runs from ``t0``, itself a step
    end."""
    ends = [t for t in step_ends if t0 < t <= t1]
    return [b - a for a, b in zip([t0] + ends[:-1], ends)]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q < 100) of all the values, by linear
    interpolation between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
