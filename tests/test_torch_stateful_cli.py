"""``--stateful`` campaigns of the port's CLI against the JAX package's,
on the CPU (``--device cpu``; the JAX package's xla engine, on the
virtual 8-device CPU mesh for ``--mesh``).  Each case mirrors one of
``tests/test_stateful.py``:

  * both CLIs at ``--stateful`` on ``tcp_like``, ``-b 64``, at ``-fb 0``
    and at the default ``-fb`` with ``Fuzzer.PIPELINE_DEPTH = 1`` on both
    packages: md5 sets, ``-isd`` (with ``virgin_state``), ``-msd`` and
    ``fuzzer_stats`` counters;
  * ``-G 4`` against the JAX package's ``-G 4`` and, at ``-fb 0``,
    against the port's host-driven loop;
  * ``--mesh 2,1``, host-driven and at ``-G 4``, against the JAX mesh;
  * the corpus entries' ``state_sig`` sidecars and the ``state_cov``
    events and gauges;
  * the ``--stateful`` refusals (``--crack``, a non-jit_harness
    instrumentation) and the ``--stateful M`` capacity override.

Tolerance: none (bytes and integer counters)."""

import json
import os

import pytest
import torch

from killerbeez_tpu.corpus.store import CorpusStore as JaxStore
from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu_torch.corpus.store import CorpusStore
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.models import targets_stateful as ts
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.telemetry.events import read_events

torch.set_num_threads(1)

COUNTERS = ("execs_done", "paths_total", "unique_crashes", "unique_hangs")


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    path = tmp_path_factory.mktemp("stateful") / "seq.bin"
    path.write_bytes(ts.framed_seed("tcp_like"))
    return path


def _findings(root):
    return {kind: sorted(f for f in os.listdir(os.path.join(root, kind))
                         if len(f) == 32)
            for kind in ("crashes", "hangs", "new_paths")}


def _run(pkg, seed, out, *extra, n=1024, target="tcp_like"):
    """One package's CLI at --stateful with PIPELINE_DEPTH = 1 on both
    Fuzzer classes; returns what the two packages must agree on."""
    argv = ["file", "jit_harness", "havoc", "-sf", str(seed),
            "-m", '{"seed": 11}', "-b", "64", "-n", str(n),
            "-o", str(out), "-i", json.dumps({"target": target}),
            "--stateful", "-isd", f"{out}.isd", "-msd", f"{out}.msd",
            *extra]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxFuzzer, Fuzzer):
            mp.setattr(cls, "PIPELINE_DEPTH", 1)
        assert (jax_main if pkg == "jax" else main)(argv) == 0
    with open(os.path.join(out, "fuzzer_stats")) as f:
        stats = dict(line.split(":", 1) for line in f)
    return {"findings": _findings(out),
            "isd": open(f"{out}.isd").read(),
            "msd": open(f"{out}.msd").read(),
            "counters": {k.strip(): v.strip() for k, v in stats.items()
                         if k.strip() in COUNTERS}}


@pytest.mark.parametrize("extra", [["-fb", "0"], []],
                         ids=["fb0", "default-fb"])
def test_host_loop_matches_jax(extra, seed, tmp_path):
    ref = _run("jax", seed, tmp_path / "jax", *extra)
    got = _run("torch", seed, tmp_path / "torch", *extra)
    assert got == ref
    assert got["findings"]["new_paths"] and got["findings"]["crashes"]
    assert "virgin_state" in json.loads(got["isd"])
    assert got["counters"]["execs_done"] == "1024"


def _sigs(pkg, out):
    store = JaxStore if pkg == "jax" else CorpusStore
    return {e.md5: e.state_sig for e in store(str(out / "corpus")).load()}


def test_generations_match_jax_and_the_host_loop(seed, tmp_path):
    """-G 4 at the default -fb (device reseeding) against the JAX
    package's -G 4, the ledger's admissions with their state_sig
    sidecars; at -fb 0 against the port's host-driven loop."""
    sigs = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        sigs[pkg] = (_run(pkg, seed, out, "-G", "4", "--corpus-dir",
                          str(out / "corpus")), _sigs(pkg, out))
    assert sigs["torch"] == sigs["jax"]
    got, got_sigs = sigs["torch"]
    assert got["findings"]["new_paths"] and got_sigs
    assert all(got_sigs.values())
    gen = _run("torch", seed, tmp_path / "gen0", "-G", "4", "-fb", "0")
    host = _run("torch", seed, tmp_path / "host0", "-fb", "0")
    assert gen["findings"] == host["findings"]
    assert gen["isd"] == host["isd"] and gen["counters"] == host["counters"]


@pytest.mark.parametrize("extra", [["-fb", "0"], ["-G", "4"]],
                         ids=["host-driven", "G4"])
def test_mesh_matches_jax(extra, seed, tmp_path):
    ref = _run("jax", seed, tmp_path / "jax", "--mesh", "2,1", *extra)
    got = _run("torch", seed, tmp_path / "torch", "--mesh", "2,1", *extra)
    assert got == ref
    assert got["findings"]["new_paths"]
    assert json.loads(got["isd"])["virgin_state"]


def test_state_sig_sidecars_and_state_cov_events(seed, tmp_path):
    """Every admitted entry's sidecar carries the JAX package's
    state_sig; the state_cov events and gauges follow the state map."""
    sigs = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        _run(pkg, seed, out, "--corpus-dir", str(out / "corpus"))
        sigs[pkg] = _sigs(pkg, out)
    assert sigs["torch"] == sigs["jax"]
    assert sigs["torch"] and all(sigs["torch"].values())
    for sig in sigs["torch"].values():
        assert all(0 <= s < 8 and 0 <= slot < 65536 for s, slot in sig)

    # the gauges and events, through the loop itself
    out = str(tmp_path / "gauges")
    instr = JitHarnessInstrumentation(
        json.dumps({"target": "session_auth", "stateful": 1}),
        device="cpu")
    mut = HavocMutator('{"seed": 2}', ts.framed_seed("session_auth"),
                       device="cpu")
    fz = Fuzzer(driver_factory("file", None, instr, mut, device="cpu"),
                output_dir=out, batch_size=64, feedback=0)
    fz.run(256)
    gauges = fz.telemetry.registry.gauges
    assert gauges["state_cov_pairs"] > 0
    assert gauges["state_cov_states"] >= 2
    evs = [e for e in read_events(os.path.join(out, "events.jsonl"))
           if e["type"] == "state_cov"]
    assert evs and evs[-1]["pairs"] == gauges["state_cov_pairs"]
    assert (evs[-1]["pairs"], evs[-1]["states"]) == \
        instr.state_coverage_stats()


def test_stateful_capacity_override_matches_jax(seed, tmp_path):
    ref = _run("jax", seed, tmp_path / "jax", "-fb", "0", "--stateful",
               "2", n=256)
    got = _run("torch", seed, tmp_path / "torch", "-fb", "0",
               "--stateful", "2", n=256)
    assert got == ref
    assert json.loads(got["isd"])["stateful"]["m_max"] == 2


@pytest.mark.parametrize("argv,word", [
    (["file", "return_code", "bit_flip", "--stateful", "-n", "1",
      "-d", '{"path": "/bin/true"}'], "jit_harness"),
    (["file", "jit_harness", "havoc", "-i", '{"target": "session_auth"}',
      "--stateful", "--crack", "-n", "64"], "session"),
], ids=["needs-jit_harness", "crack"])
def test_stateful_refusals_match_jax(argv, word, seed, tmp_path, capsys):
    argv = argv + ["-sf", str(seed), "-o", str(tmp_path / "o")]
    assert jax_main(argv) == 2
    jerr = capsys.readouterr().err
    assert main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert word in err and word in jerr
    assert err.split(" — ")[0] == jerr.split(" — ")[0]
