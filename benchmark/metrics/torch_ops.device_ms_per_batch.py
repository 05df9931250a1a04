"""Device ms per batch (per generation under ``-G``) of every
operation in the profiled stretch (on the card's stream, between
the fence's markers) that is not one of the hand kernels
(``kbz_fuzz_kernel``, ``kbz_vm_kernel``): the triage's and every other
torch op, copy and fill."""

from kbbench import devtrace


def read(r):
    if r.stretch is None or not r.stretch_batches():
        return None
    return devtrace.torch_op_ns(r.stretch) / 1e6 / r.stretch_batches()
