"""The port's crack stage (``--crack``, ``--vsa``, ``--no-focus``,
``--descend`` on both engines) against the JAX package's, with
``Fuzzer.PIPELINE_DEPTH = 1`` on both packages: the same md5 sets,
``-isd``/``-msd`` state strings, solver cache in ``checkpoint.json``
and ``solver_*``/``search_*`` counters; each package resumes the
other's crack campaign exactly as its own (no edge re-solved); a
blind crack campaign reaches full static coverage and the planted
crash, persists its cache, and installs a focus mask on an unsolvable
frontier; and the CLI's refusals.  Tolerance: none."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.crack import BranchCracker
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.factory import (
    instrumentation_factory,
)
from killerbeez_tpu_torch.mutators.factory import mutator_factory

torch.set_num_threads(1)


def _campaign(pkg, out, target, *extra, batch=128, n=6144,
              seed="\x00" * 8, corpus=True):
    iopts = {"target": target, "novelty": "throughput",
             "engine": "xla" if pkg == "jax" else "torch"}
    argv = ["file", "jit_harness", "havoc", "-ss", seed,
            "-m", '{"seed": 11}', "-b", str(batch), "-n", str(n),
            "-o", str(out), "-i", json.dumps(iopts),
            "-isd", f"{out}.isd", "-msd", f"{out}.msd", *extra]
    if corpus:
        argv += ["--corpus-dir", f"{out}/corpus"]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxFuzzer, Fuzzer):
            mp.setattr(cls, "PIPELINE_DEPTH", 1)
        assert (jax_main if pkg == "jax" else main)(argv) == 0
    return _summary(out)


def _summary(out):
    with open(os.path.join(out, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    ck = {}
    path = os.path.join(out, "corpus", "checkpoint.json")
    if os.path.exists(path):
        with open(path) as f:
            ck = json.load(f)
    counters = (ck.get("campaign") or {}).get("counters") or {}
    return {
        "findings": {d: sorted(os.listdir(os.path.join(out, d)))
                     for d in ("crashes", "hangs", "new_paths")},
        "isd": open(f"{out}.isd").read(),
        "msd": open(f"{out}.msd").read(),
        "solver": ck.get("solver"),
        "vsa": ck.get("vsa"),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("solver_", "search_"))},
        "crack_events": [(e["type"], e.get("injected"), e.get("edge"),
                          e.get("status"))
                         for e in events
                         if e["type"] in ("plateau", "crack_injection",
                                          "descent")],
    }


CASES = [
    ("test", ("--crack", "2"), "solved"),
    ("test", ("--crack", "2", "--no-focus"), "solved"),
    ("cgc_like", ("--crack", "2", "--vsa"), "solved"),
    ("magicsum_vm", ("--crack", "2", "--descend", "8",
                     "--descend-engine", "host", "--descend-lanes",
                     "128"), "searched"),
    ("magicsum_vm", ("--crack", "2", "--descend", "8",
                     "--descend-engine", "device", "--descend-lanes",
                     "128", "--descend-scan-iters", "4"), "descended"),
]


@pytest.mark.parametrize("target,extra,expect", CASES,
                         ids=[f"{t}{''.join(e[2:])}" for t, e, _ in CASES])
def test_crack_campaign_matches_jax(target, extra, expect, tmp_path):
    ref = _campaign("jax", tmp_path / "jax", target, *extra)
    got = _campaign("torch", tmp_path / "torch", target, *extra)
    assert got == ref
    assert ("plateau", None, None, None) in got["crack_events"]
    assert got["counters"].get("solver_attempts", 0) > 0
    if expect == "solved":
        assert got["counters"].get("solver_injected", 0) > 0
    else:
        assert got["counters"].get("search_attempts", 0) > 0
        assert all("search" in v for v in got["solver"].values()
                   if v["status"] != "solved")
    if expect == "descended":
        assert got["solver"]["4:5"]["status"] == "descended"
        assert got["counters"].get("search_i2s_matches", 0) > 0
    if "--vsa" in extra:
        assert got["vsa"] is not None


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_each_package_resumes_the_others_crack_campaign(first, tmp_path):
    """A crack campaign of one package, resumed by each package: both
    resumes start from the cached verdicts (no edge re-solved) and end
    identical."""
    base = tmp_path / "base"
    _campaign(first, base, "cgc_like", "--crack", "2", "--vsa",
              n=3072)
    ends = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        shutil.copytree(base, out)
        for suffix in (".isd", ".msd"):
            shutil.copy(f"{base}{suffix}", f"{out}{suffix}")
        ends[pkg] = _campaign(pkg, out, "cgc_like", "--crack", "2",
                              "--vsa", "--resume", n=3072)
    assert ends["torch"] == ends["jax"]
    before = _summary(base)
    assert before["solver"]
    # the resumed campaign kept every cached verdict
    for k, v in before["solver"].items():
        assert ends["torch"]["solver"][k] == v


def _library_campaign(tmp_path, target, n_batches=40, batch=64,
                      store=True):
    """A blind-seed campaign through the library (depth 1, so the
    plateau window is the cracker's own)."""
    instr = instrumentation_factory(
        "jit_harness", json.dumps({"target": target,
                                   "novelty": "throughput"}),
        device="cpu")
    mut = mutator_factory("havoc", '{"seed": 11}', b"\x00" * 8,
                          device="cpu")
    drv = driver_factory("file", None, instr, mut, device="cpu")
    fz = Fuzzer(drv, output_dir=str(tmp_path / "out"), batch_size=batch,
                corpus_dir=str(tmp_path / "corpus") if store else None)
    fz.PIPELINE_DEPTH = 1
    fz.cracker = BranchCracker(instr.program, plateau_batches=1,
                               store=fz.store, device="cpu")
    fz.run(batch * n_batches)
    return fz, instr, mut


def test_crack_reaches_full_static_coverage(tmp_path):
    """A blind-seed campaign lights every static edge of the
    magic-byte target, finds the planted crash, and clears its focus
    mask with the frontier."""
    fz, instr, mut = _library_campaign(tmp_path, "test")
    vb = instr.virgin_bits.numpy()
    covered = set(np.flatnonzero(vb != 0xFF).tolist())
    assert {int(s) for s in instr.program.edge_slot} <= covered
    reg = fz.telemetry.registry
    assert reg.counters.get("solver_solved", 0) > 0
    assert reg.counters.get("solver_injected", 0) > 0
    assert fz.stats.crashes >= 1
    assert mut.focus_positions is None
    assert reg.gauges.get("solver_frontier") == 0


def test_crack_cache_persists_and_resumes(tmp_path):
    fz, instr, _ = _library_campaign(tmp_path, "test")
    ck = json.loads((tmp_path / "corpus" / "checkpoint.json").read_text())
    cache = ck["solver"]
    assert any(v.get("status") == "solved" for v in cache.values())
    c2 = BranchCracker(instr.program, store=fz.store, device="cpu")
    assert c2.cache == cache


def test_crack_installs_focus_mask_on_unsolvable_frontier(tmp_path,
                                                          monkeypatch):
    """Edges marked unsolvable stay uncovered: the cracker installs the
    frontier's dependency bytes as the mutators' focus mask, and the
    fused path stands down until it clears."""
    fz, instr, mut = _library_campaign(tmp_path, "test", n_batches=4,
                                       store=False)
    cracker = fz.cracker
    for e in cracker.edges:
        cracker.cache[cracker._key(e)] = {"status": "unknown",
                                          "reason": "test"}
    instr.virgin_bits = torch.full_like(instr.virgin_bits, 0xFF)
    cracker.crack(fz)
    assert mut.focus_positions is not None
    assert set(mut.focus_positions.tolist()) <= {0, 1, 2, 3}
    monkeypatch.setattr(instr, "engine", "cuda_fused")
    assert not instr.wants_fused(mut)
    mut.set_focus_mask(None)
    assert instr.wants_fused(mut)


def test_generations_stand_down_while_cracking(tmp_path, capfd):
    """``-G`` with ``--crack``: the host-driven loop runs, with the
    JAX package's warning."""
    _campaign("torch", tmp_path / "g", "test", "--crack", "2", "-G", "4",
              n=1024, corpus=False)
    err = "".join(capfd.readouterr())
    assert "--generations stood down: the crack stage injects" in err


@pytest.mark.parametrize("extra,needle", [
    (["--descend", "8"], "--descend escalates"),
    (["--vsa"], "--vsa seeds"),
    (["--crack", "2", "--mesh", "1,1"], "--crack needs a KBVM"),
])
def test_crack_refusals_exit_2(extra, needle, tmp_path, capsys):
    argv = ["file", "jit_harness", "havoc", "-ss", "AAAA", "-n", "64",
            "-b", "64", "-o", str(tmp_path), "--device", "cpu",
            "-i", '{"target": "test"}', *extra]
    assert main(argv) == 2
    assert needle in capsys.readouterr().err

