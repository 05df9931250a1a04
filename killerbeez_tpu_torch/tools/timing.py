"""Device time of a function's work on the card, with CUDA events.

An event pair around ``fn()`` measures the card's time from the first
event to the second.  When the host takes longer to enqueue ``fn()``'s
work than the card takes to run it (a wrapper's allocations, a few
small torch ops, the ctypes call), the card sits idle in between and
the pair measures the host.  So ``timed`` first holds the card with a
spin kernel (``torch.cuda._sleep``) long enough for the host to enqueue
all of ``fn()``'s work behind it: the pair then measures the device
work alone.  ``host_ms`` is the host's time to enqueue it.  A function
that waits on the card itself (``.item()``, a host copy) cannot be
queued ahead; its time includes the host's.
"""

from __future__ import annotations

import statistics
import time

import torch

#: cycles the card spins before each timed call: about 10 ms at the
#: H100's 1.98 GHz, longer than any wrapper here takes to enqueue
HOLD_CYCLES = 20_000_000


def timed(fn, runs: int = 7, warmup: int = 1) -> float:
    """Median device milliseconds of ``fn()``'s work over ``runs``
    CUDA-event-timed calls, each queued behind a hold of the card,
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, runs: int = 7) -> float:
    """Median host milliseconds to enqueue ``fn()`` (no wait on the
    card: the card is held meanwhile, so queueing never blocks)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def in_turns(a, b, runs: int = 7):
    """Device times of a, b, b, a: returns ([a1, a2], [b1, b2])."""
    ta1, tb1 = timed(a, runs), timed(b, runs)
    tb2, ta2 = timed(b, runs), timed(a, runs)
    return [ta1, ta2], [tb1, tb2]
