"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads no part of the program.  Top-level module names are
compared whole: ``killerbeez_tpu_torch`` begins with
``killerbeez_tpu`` but is not it."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "killerbeez_tpu"}


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _dirs, names in os.walk(top):
        if os.sep + "tests" in d[len(BENCH):]:
            continue
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_sources_import_neither_jax_nor_the_jax_package():
    for path in _sources():
        assert not set(_imported(path)) & FORBIDDEN, path


def test_the_reference_sources_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert not set(_imported(path)) & (FORBIDDEN
                                           | {"killerbeez_tpu_torch"}), path


def _run(code):
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([BENCH, ROOT])})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split()[-1].split(","))


def test_the_loaded_reference_holds_no_program_module():
    names = _run(
        "import sys\n"
        "from reference import generations, havoc, prng, triage, vm\n"
        "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "reference" in names
    assert not names & (FORBIDDEN | {"killerbeez_tpu_torch"})


@pytest.mark.parametrize("cell", ["tlvstack.fb", "tlvstack.gen16"])
def test_a_cpu_dry_run_loads_no_jax(cell):
    names = _run(
        "import sys\n"
        "from kbbench import main as bench\n"
        "def prep(f):\n"
        "    f.driver.instrumentation.engine = 'cuda_fused'\n"
        f"res, _ = bench.run_cell({cell!r}, 2**31 + 5, 1.0, False, "
        "device='cpu', prepare=prep, log=lambda s: None, "
        "tiny={'lanes': 32, 'warmup_steps': 1})\n"
        "assert res['correct'], res\n"
        "assert bench.forbidden_modules() == []\n"
        "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "killerbeez_tpu_torch" in names
    assert not names & FORBIDDEN
