"""The port's supervisor (``kbz-supervise``,
``resilience/supervisor.py``) against the JAX package's, on the CPU.
Each case mirrors one of ``tests/test_resilience.py``'s supervisor
tests: the same stub child (a fuzzer stand-in that exits with a
scripted code and records its argv) runs under both supervisors, and
the launches (argv, ``--resume``, the injected ``--corpus-dir``, a
degraded ``--mesh``, the fallback argv) and the supervision log's
decisions (exit classes, restarts, probes, degrades, fallbacks, give
ups) are equal; exit classification, the mesh shrink and the jittered
backoff are equal; the default device probe counts CUDA cards with
torch in a fresh interpreter; and a supervised port campaign survives
an injected device loss and a SIGKILL with the fault-free run's
findings.  Tolerance: none."""

import json
import os
import random
import subprocess
import sys

import pytest

from killerbeez_tpu.resilience import supervisor as jax_sup
from killerbeez_tpu_torch.resilience import supervisor as sup_mod
from killerbeez_tpu_torch.resilience.supervisor import (
    CLEAN, CRASH, DEVICE_LOST, Supervisor, classify_exit, shrink_mesh,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = b"\x00" * 8


def _stub_child(d, rcs):
    """A child command that exits with rcs[launch#] and records its
    argv."""
    d.mkdir(parents=True, exist_ok=True)
    script = d / "stub.py"
    script.write_text(
        "import json, os, sys\n"
        "d = os.path.dirname(os.path.abspath(__file__))\n"
        "p = os.path.join(d, 'launches.json')\n"
        "hist = json.load(open(p)) if os.path.exists(p) else []\n"
        "hist.append(sys.argv[1:])\n"
        "json.dump(hist, open(p, 'w'))\n"
        f"rcs = {rcs!r}\n"
        "sys.exit(rcs[min(len(hist) - 1, len(rcs) - 1)])\n")
    return [sys.executable, str(script)]


#: the JAX suite's scenarios: (argv after -o, stub exit codes,
#: supervisor keyword arguments)
SCENARIOS = {
    "restart_into_resume": ([], [1, 0], {}),
    "restart_budget": ([], [1], {"max_restarts": 2}),
    "device_loss_mesh_degrade": (["--mesh", "4,2"], [87, 0],
                                 {"probe_cmd": "echo 4"}),
    "degrade_keeps_generations": (
        ["--mesh", "6,1", "-b", "96", "-G", "8", "-fb", "0"], [87, 0],
        {"probe_cmd": "echo 4"}),
    "native_fallback": ([], [87, 0], {
        "probe_cmd": "echo 0", "probe_attempts": 2,
        "fallback": "stdin return_code havoc -o OUT"}),
    "give_up_without_fallback": ([], [87], {
        "probe_cmd": "echo 0", "probe_attempts": 2}),
    "watchdog_restart": ([], [86, 0], {}),
}


def _decisions(cls, d, argv, rcs, kw):
    out = d / "out"
    kw = dict(kw)
    if "fallback" in kw:
        kw["fallback"] = kw["fallback"].replace("OUT", str(out))
    sup = cls(["-o", str(out), *argv],
              child_cmd=_stub_child(d, rcs), backoff_base=0.01,
              backoff_cap=0.02, sleep_fn=lambda s: None,
              rng=random.Random(0), **kw)
    rc = sup.run()
    with open(d / "launches.json") as f:
        launches = json.load(f)
    keep = ("event", "class", "rc", "n", "attempt", "devices", "need",
            "mesh_from", "mesh_to", "reason", "restarts", "backoff_s")
    log = [{k: r[k] for k in keep if k in r}
           for r in map(json.loads, open(out / "supervisor.jsonl"))]
    return rc, sup.restarts, launches, log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_decisions_match_jax(name, tmp_path):
    argv, rcs, kw = SCENARIOS[name]
    mine = _decisions(Supervisor, tmp_path / "torch", argv, rcs, kw)
    ref = _decisions(jax_sup.Supervisor, tmp_path / "jax", argv, rcs, kw)
    mine_s = json.dumps(mine).replace(str(tmp_path / "torch"), "D")
    ref_s = json.dumps(ref).replace(str(tmp_path / "jax"), "D")
    assert mine_s == ref_s
    rc, restarts, launches, log = mine
    if name == "restart_into_resume":
        assert rc == 0 and restarts == 1 and len(launches) == 2
        assert "--resume" not in launches[0] and "--resume" in launches[1]
        assert "--corpus-dir" in launches[0]
        assert [r["class"] for r in log if r["event"] == "exit"] == \
            [CRASH, CLEAN]
    elif name == "restart_budget":
        assert rc == 1 and len(launches) == 3
    elif name == "device_loss_mesh_degrade":
        assert launches[1][launches[1].index("--mesh") + 1] == "2,2"
    elif name == "degrade_keeps_generations":
        rebuilt = launches[1]
        assert rebuilt[rebuilt.index("--mesh") + 1] == "4,1"
        assert rebuilt[rebuilt.index("-G") + 1] == "8"
    elif name == "native_fallback":
        assert launches[1][:3] == ["stdin", "return_code", "havoc"]
        assert "--resume" in launches[1]
    elif name == "give_up_without_fallback":
        assert rc == 87 and any(r["event"] == "giveup" for r in log)


@pytest.mark.parametrize("rc,tail", [
    (0, []), (1, []), (86, []), (87, []), (-9, []),
    (1, ["XlaRuntimeError: DEVICE_LOST"]), (1, ["Traceback", "boom"]),
    (2, ["error: something else"]), (1, ["the slice became unhealthy"]),
])
def test_classify_exit_matches_jax(rc, tail):
    assert classify_exit(rc, tail) == jax_sup.classify_exit(rc, tail)


def test_classify_exit_knows_a_lost_card():
    assert classify_exit(1, ["RuntimeError: CUDA error: GPU has fallen "
                             "off the bus"]) == DEVICE_LOST
    assert classify_exit(1, ["RuntimeError: CUDA error: an illegal "
                             "memory access was encountered"]) == CRASH


def test_shrink_mesh_and_backoff_match_jax():
    for args in (("6,1", 5, 96), ("6,1", 5, 0), ("4,2", 4, 64),
                 ("4,2", 1, 64), ("8,1", 3, 0), ("bad", 2, 0)):
        assert shrink_mesh(*args) == jax_sup.shrink_mesh(*args)
    a = Supervisor(["-o", "x"], backoff_base=1.0, backoff_cap=8.0,
                   rng=random.Random(0))
    b = jax_sup.Supervisor(["-o", "x"], backoff_base=1.0, backoff_cap=8.0,
                           rng=random.Random(0))
    for streak in range(1, 8):
        a.streak = b.streak = streak
        assert a.backoff_seconds() == b.backoff_seconds()


def test_default_probe_counts_cuda_cards_with_torch(tmp_path):
    assert "torch.cuda.device_count()" in sup_mod._DEFAULT_PROBE
    assert "jax" not in sup_mod._DEFAULT_PROBE
    sup = Supervisor(["-o", str(tmp_path)])
    assert sup.child_cmd[-1] == "killerbeez_tpu_torch.fuzzer"
    import torch
    assert sup.probe_devices() == torch.cuda.device_count()


def test_supervise_cli_requires_fuzzer_argv():
    assert sup_mod.main(["--max-restarts", "1", "--"]) == 2


def _cli_args(out, extra=()):
    return ["file", "jit_harness", "havoc", "--device", "cpu",
            "-i", '{"target": "cgc_like", "novelty": "throughput"}',
            "-m", '{"seed": 11}', "-fb", "0",
            "-sf", "seed.bin", "-o", out, "-b", "256", "-n", "1024",
            "--corpus-dir", os.path.join(out, "corpus"), *extra]


def _findings(root):
    return {kind: sorted(n for n in (os.listdir(os.path.join(root, kind))
                                     if os.path.isdir(os.path.join(
                                         root, kind)) else [])
                         if len(n) == 32)
            for kind in ("crashes", "hangs", "new_paths")}


def _env():
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    env.pop("KBZ_CHAOS", None)
    return env


def test_supervised_campaign_survives_device_loss_and_sigkill(tmp_path):
    """A supervised port campaign eats an injected device loss and a
    SIGKILL at a persistence point, restarts into --resume each time,
    and ends with the fault-free run's findings and store, which are
    the JAX package's."""
    (tmp_path / "seed.bin").write_bytes(SEED)
    ctl = subprocess.run(
        [sys.executable, "-m", "killerbeez_tpu_torch.fuzzer",
         *_cli_args("ctl")], cwd=str(tmp_path), env=_env(),
        capture_output=True, text=True, timeout=180)
    assert ctl.returncode == 0, ctl.stderr[-2000:]
    ref = subprocess.run(
        [sys.executable, "-m", "killerbeez_tpu.fuzzer",
         *[a for a in _cli_args("ref") if a not in ("--device", "cpu")]],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=180)
    assert ref.returncode == 0, ref.stderr[-2000:]
    spec = json.dumps({"seed": 3, "faults": [
        {"point": "device_dispatch", "mode": "raise", "hit": 3},
        {"point": "persist", "mode": "kill", "hit": 6}]})
    r = subprocess.run(
        [sys.executable, "-m", "killerbeez_tpu_torch.resilience.supervisor",
         "--backoff-base", "0.05", "--backoff-cap", "0.2",
         "--probe-cmd", "echo 1", "--chaos", spec,
         "--chaos-launches", "2", "--", *_cli_args("out")],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = str(tmp_path / "out")
    assert any(_findings(out).values())
    assert _findings(out) == _findings(str(tmp_path / "ctl")) == \
        _findings(str(tmp_path / "ref"))
    store = sorted(n for n in os.listdir(os.path.join(out, "corpus"))
                   if len(n) == 32)
    assert store == sorted(
        n for n in os.listdir(str(tmp_path / "ctl" / "corpus"))
        if len(n) == 32)
    recs = [json.loads(line)
            for line in open(os.path.join(out, "supervisor.jsonl"))]
    classes = [r.get("class") for r in recs if r["event"] == "exit"]
    assert DEVICE_LOST in classes and CRASH in classes
    assert classes[-1] == CLEAN
    assert any(r["event"] == "device_probe" for r in recs)
