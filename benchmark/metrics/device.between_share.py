"""Percent of the card's stream time over the window that lay between
dispatches, from the program's own device spans: the growth of
``dev_between_seconds`` (a dispatch's end mark to the next one's begin
mark) over that of ``dev_dispatch_seconds`` plus it."""


def read(r):
    w = r.window
    if "dev_between_seconds" not in w.counters1:
        return None
    between = r.counter_delta("dev_between_seconds")
    total = r.counter_delta("dev_dispatch_seconds") + between
    if total <= 0:
        return None
    return 100.0 * between / total
