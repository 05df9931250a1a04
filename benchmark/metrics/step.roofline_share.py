"""Percent of the profiled stretch's device busy time that the chip
would need at its peaks (3.35 TB/s, 16.7 TOP/s int32, derived) for the
work of the stretch's batches: havoc edits, the VM steps the lanes ran,
throughput triage (``kbbench/arith``)."""


def read(r):
    if r.stretch is None or r.stretch_bound_s is None or \
            r.stretch.busy_ns <= 0:
        return None
    return 100.0 * r.stretch_bound_s / (r.stretch.busy_ns * 1e-9)
