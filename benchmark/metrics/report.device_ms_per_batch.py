"""Device ms per batch (per generation under ``-G``) of the report,
timed on the card by the program itself: the growth of its
``dev_report_seconds`` device span (verdict packing and the
compaction of the interesting lanes, or under ``-G`` the findings
ring's append and the seed ring's admission) over the window's
batches."""


def read(r):
    w = r.window
    batches = r.counter_delta("execs") / r.cell.config["lanes"]
    if "dev_report_seconds" not in w.counters1 or batches <= 0:
        return None
    return 1e3 * r.counter_delta("dev_report_seconds") / batches
