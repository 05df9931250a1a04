"""``--hybrid`` campaigns of the port's CLI against the JAX package's, on
the CPU (``--device cpu``; the JAX package's xla engine, on the virtual
8-device CPU mesh for ``--mesh``), with native validation on the real
corpus binaries: the JAX side's from the ``corpus_bin`` fixture, the
port's from its own build under ``build/torch_native/corpus/``.

Both CLIs run ``file jit_harness havoc -m '{"seed": 7}' -i '{"target":
"test"}' -b 64 -n 512`` from a seed of ``ABCD`` followed by 60 zero
bytes, with ``Fuzzer.PIPELINE_DEPTH = 1`` on both packages and
``--hybrid-workers 0`` (every verdict made at the end of the run, so
the event order is fixed): host-driven, at ``-G 4`` and at ``--mesh
1,1``, each with ``--hybrid test`` (the faithful pair: ``confirmed``)
and ``--hybrid test_safe`` (the divergent pair: ``proxy_only`` and a
proxy-gap report).  The padded seed matters: from the bare 4-byte
``ABCD`` the havoc stream never runs the planted input and finds no
crash in 512 execs, while most lanes of a 64-byte seed leave its first
four bytes alone.  Then one ``--hybrid test_safe --auto-repair 1`` run
in each package installs ``test_safe+repaired`` and writes the same
``repairs.json``.

They must agree on the md5 sets, the ``cross_tier_validate`` and
``proxy_gap`` events, the ``crashes/<md5>.json`` sidecars, the
``proxy_gaps/`` reports and index, the ``hybrid_*`` and ``repair_*``
counters, and both bridges must validate every finding they queued
with none dropped.  Records are compared with their wall-clock fields
(``t``, ``wall_s``, ``seconds``, the event envelope) dropped, output
paths made relative and native argv reduced to the binary's name (each
package runs its own build of the same source).  Tolerance: none."""

import json
import os

import pytest
import torch

import killerbeez_tpu.hybrid as jax_hybrid
import killerbeez_tpu_torch.hybrid as hybrid
from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.hybrid import registry as jax_registry
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.hybrid import registry
from killerbeez_tpu_torch.native import build

torch.set_num_threads(1)

#: wall-clock fields, dropped before records are compared
CLOCK = ("t", "ts", "wall_s", "seconds")


@pytest.fixture(autouse=True)
def _forget_repaired_bindings():
    """A test that installs ``test_safe+repaired`` takes it out of both
    registries again, so no later test in the process sees it."""
    yield
    for reg in (registry, jax_registry):
        reg._BINDINGS.pop("test_safe+repaired", None)


@pytest.fixture(scope="module")
def port_bin():
    try:
        build.build_corpus(["test-plain", "hybrid-safe"])
    except RuntimeError as e:
        pytest.skip(f"native build unavailable: {e}")


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    path = tmp_path_factory.mktemp("hybrid") / "seed.bin"
    path.write_bytes(b"ABCD" + bytes(60))
    return path


def _norm(obj, out):
    """``obj`` without wall-clock fields, with ``out`` made relative and
    native argv reduced to the binary's name."""
    if isinstance(obj, dict):
        return {k: ([os.path.basename(a) for a in v] if k == "argv"
                    else _norm(v, out))
                for k, v in obj.items() if k not in CLOCK}
    if isinstance(obj, list):
        return [_norm(v, out) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(out), "<out>")
    return obj


def _read_json_dir(path, out):
    if not os.path.isdir(path):
        return {}
    return {name: _norm(json.load(open(os.path.join(path, name))), out)
            for name in sorted(os.listdir(path)) if name.endswith(".json")}


def _run(pkg, seed, out, *extra):
    """One package's CLI with PIPELINE_DEPTH = 1 on both Fuzzer classes
    and its bridge captured; returns what the two packages must agree
    on, and the bridge."""
    made = []
    mod = jax_hybrid if pkg == "jax" else hybrid
    make = mod.make_bridge

    def capture(*a, **k):
        bridge = make(*a, **k)
        fold = bridge.fold

        def fold_and_keep(fuzzer):
            bridge.fuzzer = fuzzer
            return fold(fuzzer)
        bridge.fold = fold_and_keep
        made.append(bridge)
        return bridge

    argv = ["file", "jit_harness", "havoc", "-sf", str(seed),
            "-m", '{"seed": 7}', "-i", '{"target": "test"}', "-b", "64",
            "-n", "512", "-o", str(out), "-l", '{"level": 1}',
            "--hybrid-workers", "0", *extra]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxFuzzer, Fuzzer):
            mp.setattr(cls, "PIPELINE_DEPTH", 1)
        mp.setattr(mod, "make_bridge", capture)
        assert (jax_main if pkg == "jax" else main)(argv) == 0
    [bridge] = made
    counters = bridge.fuzzer.telemetry.registry.snapshot()["counters"]
    with open(os.path.join(out, "events.jsonl")) as f:
        evs = [json.loads(line) for line in f]
    return {
        "findings": {k: sorted(n for n in os.listdir(os.path.join(out, k))
                               if len(n) == 32)
                     for k in ("crashes", "hangs", "new_paths")},
        "events": [_norm({k: v for k, v in e.items()
                          if k not in ("v", "seq")}, out)
                   for e in evs if e["type"] in
                   ("cross_tier_validate", "proxy_gap", "proxy_repair")],
        "sidecars": _read_json_dir(os.path.join(out, "crashes"), out),
        "gaps": _read_json_dir(os.path.join(out, "proxy_gaps"), out),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("hybrid_", "repair_"))},
        "snapshot": bridge.snapshot(),
    }, bridge


MODES = {"host": [], "g4": ["-G", "4"], "mesh": ["--mesh", "1,1"]}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("binding", ["test", "test_safe"])
def test_hybrid_campaign_matches_jax(corpus_bin, port_bin, seed, tmp_path,
                                     binding, mode):
    args = ["--hybrid", binding, *MODES[mode]]
    got, bridges = {}, {}
    for pkg in ("jax", "torch"):
        got[pkg], bridges[pkg] = _run(pkg, seed, tmp_path / pkg, *args)
        # every queued finding got a verdict: nothing dropped
        assert bridges[pkg].validated == bridges[pkg].enqueued >= 1
        assert bridges[pkg].queue.dropped == 0
    for key in got["jax"]:
        assert got["torch"][key] == got["jax"][key], key
    verdicts = [e["verdict"] for e in got["torch"]["events"]
                if e["type"] == "cross_tier_validate"]
    if binding == "test":
        assert verdicts and set(verdicts) == {"confirmed"}
        assert not got["torch"]["gaps"]
    else:
        assert verdicts and set(verdicts) == {"proxy_only"}
        assert "index.json" in got["torch"]["gaps"]
        assert got["torch"]["counters"]["hybrid_proxy_gaps"] == \
            len(verdicts)


def test_auto_repair_campaign_matches_jax(corpus_bin, port_bin, seed,
                                          tmp_path):
    """``--hybrid test_safe --auto-repair 1``: the run-end repair folds
    the gap into a verified patch in both packages, re-certifies it on
    the native binary and installs ``test_safe+repaired``."""
    args = ["--hybrid", "test_safe", "--auto-repair", "1"]
    got = {}
    for pkg in ("jax", "torch"):
        got[pkg], _ = _run(pkg, seed, tmp_path / pkg, *args)
    for key in got["jax"]:
        assert got["torch"][key] == got["jax"][key], key
    ledger = got["torch"]["gaps"]["repairs.json"]["repairs"]
    assert [r["status"] for r in ledger] == ["repaired"]
    [ev] = [e for e in got["torch"]["events"] if e["type"] == "proxy_repair"]
    assert ev["status"] == "repaired"
    assert ev["installed"] == "test_safe+repaired"
    assert got["torch"]["counters"]["repair_repaired"] == 1
    for reg in (registry, jax_registry):
        assert "test_safe+repaired" in reg.binding_names()
    assert os.path.exists(tmp_path / "torch" / "proxy_gaps"
                          / "repaired_test_safe.npz")
