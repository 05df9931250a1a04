"""Percent of the window the host loop spent waiting for the card: the
program's ``host_transfer`` stage (the wait on a batch's verdict copy,
or on a ``-G`` dispatch's report)."""


def read(r):
    return r.stage_share("host_transfer")
