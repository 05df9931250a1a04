"""Reduction of a profiled stretch to the card's busy time, its idle
gaps and its time by operation.

The profiler records device activity only.  The stretch is fenced on
the card's stream by two marker kernels (``MARKER``), so it spans the
device's execution of the profiled dispatches and the idle time
between; a third marker, launched on an idle card right after the
host read its clock, gives the offset between the host's clock and
the card's.  Busy time is the union of the device operations'
intervals inside the fence; each gap of the union is labelled by the
program stage the host was in at the gap's middle (the innermost
one), else ``untimed``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

MARKER = "spin_kernel"
#: the port's hand-written kernels; every other device operation is a
#: torch op, a copy or a fill
HAND_KERNELS = ("kbz_fuzz_kernel", "kbz_vm_kernel")
N_GAPS = 10


class Stretch(NamedTuple):
    begin_ns: int
    end_ns: int
    busy_ns: float
    by_name: Dict[str, float]          # device ns by operation name
    gaps: List[Tuple[str, float]]      # the N_GAPS longest (label, ns)

    @property
    def window_ns(self) -> int:
        return self.end_ns - self.begin_ns


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps_of(intervals: Iterable[Tuple[float, float]], begin: float,
            end: float) -> List[Tuple[float, float]]:
    """The parts of [begin, end] that no interval covers."""
    out, at = [], begin
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, end)))
        at = max(at, b)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(a, b) for a, b in out if b > a]


def label_at(t: float, spans: List[Tuple[str, float, float]]) -> str:
    """The innermost (latest-starting) span open at ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "untimed"


def reduce(events: List[Tuple[str, int, int]],
           stages: List[Tuple[str, int, int]],
           calibration_ns: int) -> Optional[Stretch]:
    """``events``: the device operations (name, start, end) in ns on the
    card's clock; ``stages``: the program's stage spans (name, start,
    end) on the host's; ``calibration_ns``: the host's clock just
    before the third marker was launched.  None without three
    markers."""
    marks = sorted((a, b) for n, a, b in events if MARKER in n)
    if len(marks) < 3:
        return None
    begin, end = marks[0][1], marks[1][0]
    offset = marks[2][0] - calibration_ns
    dev, by_name = [], {}
    for name, a, b in events:
        if MARKER in name:
            continue
        a, b = max(a, begin), min(b, end)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    spans = [(n, a + offset, b + offset) for n, a, b in stages]
    longest = sorted(gaps_of(dev, begin, end), key=lambda g: g[0] - g[1])
    gaps = [(label_at((g0 + g1) / 2, spans), g1 - g0)
            for g0, g1 in longest[:N_GAPS]]
    return Stretch(begin, end, union_length(dev), by_name, gaps)


def torch_op_ns(st: Stretch) -> float:
    """Device time of every operation that is not a hand kernel."""
    return sum(ns for name, ns in st.by_name.items()
               if not any(k in name for k in HAND_KERNELS))


def breakdown(st: Stretch) -> dict:
    """The operations that took the most device time and the longest
    idle gaps, ten of each, in seconds."""
    ops = sorted(st.by_name.items(), key=lambda x: -x[1])[:N_GAPS]
    return {"device_ops": [[name, ns * 1e-9] for name, ns in ops],
            "idle_gaps": [[label, ns * 1e-9] for label, ns in st.gaps]}
