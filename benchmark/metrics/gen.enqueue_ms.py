"""Host ms to enqueue one ``-G`` dispatch: the driver's ``execute``
stage, which wraps the generation loop's enqueue, over the window's
dispatches."""


def read(r):
    w = r.window
    if r.cell.traffic.get("check") != "generations" or \
            not w.window_dispatches:
        return None
    return 1e3 * r.counter_delta("execute_seconds") / w.window_dispatches
