"""The 95th percentile of every step of the window, in ms: a step is
one dispatch taken through triage, timed from the end of the previous
step's triage to the end of its own."""

from kbbench import stats


def read(r):
    w = r.window
    steps = stats.step_intervals(w.step_ends, w.t0, w.t1)
    if not steps:
        return None
    return 1e3 * stats.percentile(steps, 95)
