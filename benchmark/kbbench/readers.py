"""Each metric's reader is ``benchmark/metrics/<name>.py``, a module
with ``read(r)`` that returns the metric's value, or None when the run
gives it nothing to read (the metric is then left out of the line).

``r`` is a ``Reading``: the window's clocks and the program's stage
counters at its ends, the profiled stretch (``--trace 1``), the work of
the stretch's batches and the set-up time.
"""

from __future__ import annotations

import importlib.util
from typing import Any, Dict, Optional

from . import spec


class Reading:
    def __init__(self, window, cell, setup_s: float,
                 stretch=None, stretch_bound_s: Optional[float] = None):
        self.window = window
        self.cell = cell
        self.setup_s = setup_s
        self.stretch = stretch
        self.stretch_bound_s = stretch_bound_s

    def stage_share(self, stage: str) -> Optional[float]:
        """Percent of the window the host spent in the program's stage
        timer ``stage`` (its ``<stage>_seconds`` counter's growth over
        the window, to the first dispatch boundary past its end)."""
        w = self.window
        if w.t_snap1 is None:
            return None
        key = stage + "_seconds"
        d = w.counters1.get(key, 0.0) - w.counters0.get(key, 0.0)
        return 100.0 * d / (w.t_snap1 - w.t0)

    def counter_delta(self, name: str) -> float:
        w = self.window
        return w.counters1.get(name, 0.0) - w.counters0.get(name, 0.0)

    def stretch_batches(self) -> int:
        return sum(d.k for d in self.window.stretch)


_CACHE: Dict[str, Any] = {}


def reader(name: str):
    mod = _CACHE.get(name)
    if mod is None:
        path = spec.bench_path(f"metrics/{name}.py")
        s = importlib.util.spec_from_file_location(
            "kbbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        _CACHE[name] = mod
    return mod


def read_all(metrics, r: Reading) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in metrics:
        v = reader(m["name"]).read(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
