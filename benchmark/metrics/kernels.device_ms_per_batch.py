"""Device ms per batch (per generation under ``-G``) of the hand
kernels, timed on the card by the program itself: the growth of its
``dev_kernels_seconds`` device span (a batch's first mark to its mark
after the fused step: the fused kernel, two-phase, and its glue) over
the window's batches."""


def read(r):
    w = r.window
    batches = r.counter_delta("execs") / r.cell.config["lanes"]
    if "dev_kernels_seconds" not in w.counters1 or batches <= 0:
        return None
    return 1e3 * r.counter_delta("dev_kernels_seconds") / batches
