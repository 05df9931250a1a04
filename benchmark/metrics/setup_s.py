"""Seconds from the start of the process to the start of the window:
imports, the CUDA context, the kernel library (built on a checkout's
first run), the program, the warm-up."""


def read(r):
    return r.setup_s
