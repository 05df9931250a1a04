"""Percent of the profiled stretch in which no operation ran on the
card: 1 - (the union of device operations' intervals) / (the
fence's length on the card's stream)."""


def read(r):
    if r.stretch is None or r.stretch.window_ns <= 0:
        return None
    return 100.0 * (1.0 - r.stretch.busy_ns / r.stretch.window_ns)
