"""Percent of the window the host loop spent in its own telemetry: the
program's ``telemetry`` stage (rates and gauges after each dispatch,
folding the device spans, flushing the stats files)."""


def read(r):
    if "telemetry_seconds" not in r.window.counters1:
        return None
    return r.stage_share("telemetry")
