"""Percent of the window the host loop spent writing findings: the
program's ``fs_write`` stage."""


def read(r):
    return r.stage_share("fs_write")
