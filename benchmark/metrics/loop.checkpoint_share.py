"""Percent of the window the host loop spent checkpointing the
campaign: the program's ``checkpoint`` stage (``_persist_campaign``
between dispatches, time-gated inside)."""


def read(r):
    if "checkpoint_seconds" not in r.window.counters1:
        return None
    return r.stage_share("checkpoint")
