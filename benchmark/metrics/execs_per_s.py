"""Executions per second of the window: the lanes of every dispatch
that the host loop completed inside the window (the driver's call
returned: its work enqueued on the card), over the window's seconds.

The loop keeps at most a bounded pipeline of dispatches ahead of its
triage, so in a steady campaign this is the rate at which it triages
too; counting at the dispatch and not at the triage keeps the host
loop's bursts out of the count (at a rotation it triages every batch
whose results have landed).
"""

from kbbench import stats


def read(r):
    w = r.window
    return stats.rate(w.dispatched, w.t0, w.t1)
