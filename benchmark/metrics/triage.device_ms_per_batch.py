"""Device ms per batch (per generation under ``-G``) of triage, timed on
the card by the program itself: the growth of its ``dev_triage_seconds``
device span (``_judge``'s torch ops, between the marks after the fused
step and after the verdicts) over the window's batches, the
executions the window dispatched over the cell's lanes."""


def read(r):
    w = r.window
    batches = r.counter_delta("execs") / r.cell.config["lanes"]
    if "dev_triage_seconds" not in w.counters1 or batches <= 0:
        return None
    return 1e3 * r.counter_delta("dev_triage_seconds") / batches
