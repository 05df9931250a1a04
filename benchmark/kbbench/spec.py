"""A cell of ``BENCHMARK.json`` and the files it names.

A cell names a configuration (``BENCHMARK.json`` gives its file, a
campaign deployment: target program, seed, driver, instrumentation,
mutator, lanes) and a traffic mix, ``benchmark/workloads/<traffic>.json``
(the CLI's mode flags and instrumentation options, the warm-up, the
profiled stretch and the kind of check, ``benchmark/checks/<kind>.py``).
Each metric is read by ``benchmark/metrics/<name>.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json``."""
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[w["config"]]["file"], encoding="utf-8") as f:
        config = json.load(f)
    config["name"] = w["config"]
    with open(bench_path(f"workloads/{w['traffic']}.json"),
              encoding="utf-8") as f:
        traffic = json.load(f)
    traffic["name"] = w["traffic"]
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def bench_path(rel: str) -> Path:
    """A file of the benchmark, by its path under ``benchmark/``."""
    return BENCH_DIR / rel
