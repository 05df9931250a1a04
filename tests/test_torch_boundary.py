"""The port's boundaries: no module of ``killerbeez_tpu_torch`` (and
not ``chip_smoke.py``) imports JAX or the JAX package, entry points
default to the CUDA card and raise without one, and engines refuse the
wrong device."""

import ast
import json
import pathlib

import pytest
import torch

from killerbeez_tpu_torch.instrumentation.jit_harness import (
    _UNPORTED, JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.mutators.randomized import HavocMutator

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "killerbeez_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "killerbeez_tpu"), \
            f"{path.name} imports {name}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        JitHarnessInstrumentation(json.dumps({"target": "test"}))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        HavocMutator(None, b"ABCD")


def test_cuda_engine_refused_on_cpu():
    with pytest.raises(ValueError, match="needs the CUDA card"):
        JitHarnessInstrumentation(json.dumps(
            {"target": "test", "engine": "cuda_fused"}), device="cpu")


def test_torch_engine_refused_on_the_card(monkeypatch):
    # pretend a card is present: the engine check comes before any
    # tensor is placed on it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CPU only"):
        JitHarnessInstrumentation(json.dumps(
            {"target": "test", "engine": "torch"}), device="cuda")


@pytest.mark.parametrize("opt", [{"learn": 1}, {"grammar": "auto"},
                                 {"grammar_stage": 64}])
def test_unported_options_raise(opt):
    """An option still unported raises; the grammar options, ported
    since, compile the tables."""
    (key, _), = opt.items()
    if key in _UNPORTED:
        with pytest.raises(ValueError, match="not ported yet"):
            JitHarnessInstrumentation(json.dumps({"target": "test", **opt}),
                                      device="cpu")
        return
    h = JitHarnessInstrumentation(json.dumps(
        {"target": "test", "grammar": "auto", **opt}), device="cpu")
    assert h.grammar_tables is not None
    assert int(h.grammar_tables.meta[1]) == opt.get("grammar_stage", 128)
