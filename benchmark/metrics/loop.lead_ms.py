"""How far the card trails the host loop, in ms, per dispatch of the
window: the growth of the program's ``dispatch_lead_seconds`` (the
host time at which the card reached a dispatch's end mark, less the
host time at which its enqueue returned) over the window's
dispatches.  Well above 0: the card sets the pace and the host runs
ahead; near 0: the host does.  A diagnostic of who sets the pace, not
a score: a faster card (triage as one kernel) lowers it while
``execs_per_s`` rises, and so does a slower host; ``better`` reads
"lower" for the first case."""


def read(r):
    w = r.window
    if "dispatch_lead_seconds" not in w.counters1 or \
            not w.window_dispatches:
        return None
    return 1e3 * r.counter_delta("dispatch_lead_seconds") / \
        w.window_dispatches
