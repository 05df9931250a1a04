"""Percent of the window the host loop spent in corpus feedback: the
program's ``corpus_feedback`` stage (crediting the period, draining
ready batches, rotating the seed)."""


def read(r):
    return r.stage_share("corpus_feedback")
