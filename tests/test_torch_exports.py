"""The port's public names against the JAX package's.

For every module of the JAX package that has a counterpart at the same
path in ``killerbeez_tpu_torch``, each public name of the JAX module
(its ``__all__``, else the names its top level defines, and for a
package's ``__init__`` the names it imports from its own modules, that
do not start with ``_``) must be defined in the port's module, or stand on one
of the named lists below with the reason it is missing: the Queue A
item of ``ROADMAP.md`` that ports it, or why it needs no port.  The
public methods of each class that a module of both packages defines
(its own and those it inherits, ``__dunder__`` methods included) are
held to the JAX class's the same way.  The modules are read as source
(``ast``), so nothing here imports a module only to list its names."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "killerbeez_tpu"
PORT = ROOT / "killerbeez_tpu_torch"

#: names still to be ported, by module, each with its Queue A item (none:
#: every public name of the JAX modules is in the port)
UNPORTED = {}

#: names that need no port, by module, with the reason
NO_PORT = {
    "ops/vm_kernel.py": (
        "the Pallas entry points and TPU-only devices (bf16 one-hot "
        "dot modes, LANE_TILE padding); the CUDA kernels' wrappers are "
        "fuzz_batch, fuzz_batch_2phase and run_batch", [
            "DEFAULT_DOTS", "LANE_TILE", "dot_modes", "fuzz_batch_pallas",
            "fuzz_batch_pallas_2phase", "havoc_words", "run_batch_pallas",
            "run_batch_pallas_padded"]),
    "ops/generations.py": (
        "XLA buffer donation of the jitted scan's carry; the port's "
        "loop updates the ring in place", ["carry_donation_argnums"]),
    "fuzzer/loop.py": ("no caller in the JAX package", ["FINDING_DIRS"]),
}


def _public(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    names = set(_top_level(tree))
    if path.name == "__init__.py":
        # a package without __all__ exports what it imports from its
        # own modules
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.level:
                names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _top_level(tree):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    yield t.id
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            yield node.target.id


def _defined(path: pathlib.Path):
    """Names the module binds at its top level, imports included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set(_top_level(tree))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


PAIRS = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
               if (PORT / p.relative_to(JAX)).exists())


def test_pairs_cover_the_listed_modules():
    for rel in list(UNPORTED) + list(NO_PORT):
        assert rel in PAIRS, rel


@pytest.mark.parametrize("rel", PAIRS)
def test_public_names_are_ported_or_listed(rel):
    listed = set(UNPORTED.get(rel, ("", []))[1]) | \
        set(NO_PORT.get(rel, ("", []))[1])
    jax_names = _public(JAX / rel)
    mine = _defined(PORT / rel)
    missing = sorted(jax_names - mine - listed)
    assert not missing, f"{rel}: not in the port and not listed: {missing}"
    # a listed name that the port has gained must leave the list
    stale = sorted(listed & mine)
    assert not stale, f"{rel}: listed but ported: {stale}"
    assert listed <= jax_names, f"{rel}: listed names the JAX module " \
        f"does not export: {sorted(listed - jax_names)}"


def test_package_level_imports():
    from killerbeez_tpu_torch.corpus import RareEdgeScheduler
    from killerbeez_tpu_torch.models import compile_runner
    from killerbeez_tpu_torch.native import build_error, native_available
    from killerbeez_tpu_torch.ops import (
        build_bitmap, hash_bitmaps, murmur3_32, xxh64,
    )
    from killerbeez_tpu_torch.telemetry import render_openmetrics
    for obj in (RareEdgeScheduler, compile_runner, build_error,
                native_available, build_bitmap, hash_bitmaps, murmur3_32,
                xxh64, render_openmetrics):
        assert callable(obj)


def test_native_available_keeps_the_failure(monkeypatch):
    """native_available() is False with the error kept for build_error()
    when the build fails, and True when it succeeds; build_native()
    itself still raises for its callers."""
    from killerbeez_tpu_torch.native import build as nb

    def fail():
        raise RuntimeError("native build failed (make): boom")

    monkeypatch.setattr(nb, "build_native", fail)
    monkeypatch.setattr(nb, "_build_error", None)
    assert nb.native_available() is False
    assert "boom" in nb.build_error()
    with pytest.raises(RuntimeError, match="boom"):
        nb.build_native()
    monkeypatch.setattr(nb, "_build_error", None)
    monkeypatch.setattr(nb, "build_native", lambda: None)
    assert nb.native_available() is True
    assert nb.build_error() is None


#: public methods of JAX classes the port's class of the same module does
#: not have, by (module, class), with the reason
METHOD_DIFFERENCES = {
    ("parallel/distributed.py", "_ShardKernels"): (
        "device internals: the port derives the lane keys in base_key and "
        "triages one (dp, mp) shard per call in triage_row and "
        "state_triage_row, where the JAX package maps lane_keys, "
        "triage_local and state_triage_local over the mesh",
        ["lane_keys", "state_triage_local", "triage_local"]),
    ("telemetry/__init__.py", "Telemetry"): (
        "no caller in the JAX package", ["stage_summary"]),
    ("corpus/store.py", "CorpusStore"): (
        "no caller in the JAX package (the component states ride the "
        "checkpoint)", ["save_component_state"]),
}


def _classes(pkg: pathlib.Path):
    """{class name: [(module, own methods, base names)]} over a package:
    the methods a class body defines or binds by assignment."""
    out = {}
    for path in pkg.rglob("*.py"):
        rel = str(path.relative_to(pkg))
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, ast.ClassDef):
                continue
            own = {m.name for m in node.body if isinstance(
                m, (ast.FunctionDef, ast.AsyncFunctionDef))}
            own |= {t.id for m in node.body if isinstance(m, ast.Assign)
                    for t in m.targets if isinstance(t, ast.Name)}
            bases = [getattr(b, "id", getattr(b, "attr", None))
                     for b in node.bases]
            out.setdefault(node.name, []).append((rel, own, bases))
    return out


def _methods(index, name, rel, seen=()):
    """A class's public methods with those it inherits from classes of
    its package (a base of the same module first)."""
    if name not in index or name in seen:
        return set()
    defs = index[name]
    _, own, bases = next((d for d in defs if d[0] == rel), defs[0])
    names = set(own)
    for base in bases:
        names |= _methods(index, base, rel, seen + (name,))
    return {n for n in names if not n.startswith("_")
            or (n.startswith("__") and n.endswith("__"))}


JAX_CLASSES, PORT_CLASSES = _classes(JAX), _classes(PORT)
CLASS_PAIRS = sorted(
    (rel, name) for name, defs in JAX_CLASSES.items() for rel, _, _ in defs
    if any(r == rel for r, _, _ in PORT_CLASSES.get(name, ())))


def test_method_differences_name_shared_classes():
    assert set(METHOD_DIFFERENCES) <= set(CLASS_PAIRS)


@pytest.mark.parametrize("rel,name", CLASS_PAIRS,
                         ids=[f"{r}:{n}" for r, n in CLASS_PAIRS])
def test_class_methods_are_ported_or_listed(rel, name):
    listed = set(METHOD_DIFFERENCES.get((rel, name), ("", []))[1])
    jax_m = _methods(JAX_CLASSES, name, rel)
    port_m = _methods(PORT_CLASSES, name, rel)
    missing = sorted(jax_m - port_m - listed)
    assert not missing, f"{rel}:{name}: not in the port: {missing}"
    stale = sorted(listed & port_m)
    assert not stale, f"{rel}:{name}: listed but ported: {stale}"
    assert listed <= jax_m
