"""Percent of the window in which the host loop was in none of the
program's stages: 100 less the growth of every ``<stage>_self_seconds``
counter (a stage's time less the stages nested in it, so that they
partition the timed time) over the window."""


def read(r):
    w = r.window
    keys = [k for k in w.counters1 if k.endswith("_self_seconds")]
    if w.t_snap1 is None or not keys:
        return None
    timed = sum(r.counter_delta(k) for k in keys)
    return 100.0 - 100.0 * timed / (w.t_snap1 - w.t0)
