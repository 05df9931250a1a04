"""One short run of each cell on the card, through ``run.py``: exit 0,
a result line with ``correct`` true and every metric the cell reports.
Skips without a CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from kbbench import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8"))[
        "workloads"]]


@pytest.mark.device
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    c = spec.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert want <= set(res["metrics"]) | {"step_ms_p95"}
    assert res["device"]["platform"] == "gpu"
