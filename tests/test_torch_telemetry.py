"""The port's telemetry and resilience tier: the registry, the stats
sink and the event log against the JAX package's on the same scripted inputs (a fake clock
makes them deterministic; tolerance: none, the files are compared byte
for byte); the stats files and event log of a short port campaign;
the device-loss classifier's CUDA markers; the device-loss exit 87;
and the watchdog killing a ``--chaos`` hung device wait within twice
its deadline."""

import json
import os
import subprocess
import sys

import pytest
import torch

from killerbeez_tpu import telemetry as jax_tel
from killerbeez_tpu.models.targets_cgc import tlvstack_vm_seed
from killerbeez_tpu.resilience import is_device_loss as jax_is_loss
from killerbeez_tpu_torch import telemetry as tel
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.resilience import (
    DEVICE_LOST_EXIT_CODE, WATCHDOG_EXIT_CODE, chaos, is_device_loss,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(mod, out):
    """One scripted campaign's telemetry through package ``mod``: a
    fake clock, counters, gauges, stage observations, run windows and
    three sink flushes.  Returns the registry."""
    clock = _Clock()
    reg = mod.MetricsRegistry(time_fn=clock)
    sink = mod.StatsSink(str(out), reg, interval_s=5.0)
    sink.flush()
    reg.run_started()
    for step in range(12):
        clock.t += 1.5
        reg.count("execs", 4096)
        reg.count("new_paths", step % 3)
        reg.gauge("corpus_seen", step * 2)
        reg.gauge("corpus_arms", step)
        reg.observe("triage", 0.001 * (step + 1))
        reg.observe("execute", 0.0004 * (step + 2))
        if step == 7:
            reg.count("crashes")
            reg.count("unique_crashes")
        sink.maybe_flush()
    reg.run_ended()
    sink.flush()
    return reg


def test_registry_and_sink_match_jax(tmp_path):
    ref = _script(jax_tel, tmp_path / "jax")
    got = _script(tel, tmp_path / "torch")
    assert got.snapshot() == ref.snapshot()
    assert got.stage_split() == ref.stage_split()
    for name in ("fuzzer_stats", "plot_data", "stats.jsonl"):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    rows = (tmp_path / "torch" / "plot_data").read_text().splitlines()
    assert len(rows) == 1 + 5           # header, 2 flushes + 3 interval


def test_ema_rate_matches_jax():
    clocks = [_Clock(), _Clock()]
    rates = [mod.EmaRate(30.0, time_fn=c)
             for mod, c in ((jax_tel, clocks[0]), (tel, clocks[1]))]
    for step in range(40):
        for r, c in zip(rates, clocks):
            c.t += 0.25 * (1 + step % 4)
            r.add(512 * (step % 5))
        assert rates[1].as_dict() == rates[0].as_dict()


def _events(mod, out, **kw):
    log = mod.EventLog(str(out), **kw)
    for i in range(30):
        log.emit("new_path", md5=f"{i:032x}", edge_novel=i % 2 == 0,
                 new_paths=i + 1)
        if i % 10 == 9:
            log.emit("scheduler_pick", arm="base", policy="bandit",
                     rotation=i // 10 + 1)
    log.close()
    # the log as the reader sees it, without the wall-clock stamps
    return [{k: v for k, v in e.items() if k != "t"}
            for e in mod.read_events(str(out))]


@pytest.mark.parametrize("max_bytes", [0, 1500])
def test_event_log_matches_jax(max_bytes, tmp_path):
    ref = _events(jax_tel, tmp_path / "jax", max_bytes=max_bytes)
    got = _events(tel, tmp_path / "torch", max_bytes=max_bytes)
    assert got == ref and got
    assert [e["seq"] for e in got] == sorted({e["seq"] for e in got})
    if max_bytes:
        # rotation kept one older generation beside the live file
        assert (tmp_path / "torch" / "events.jsonl.1").exists()
    # resume continues the numbering past the tail, fresh restarts it
    log = tel.EventLog(str(tmp_path / "torch"))
    assert log.next_seq == got[-1]["seq"] + 1
    assert tel.EventLog(str(tmp_path / "torch"), fresh=True).next_seq == 0


def _cli(out, *extra):
    seed = out.parent / "seed.bin"
    seed.write_bytes(tlvstack_vm_seed())
    return ["file", "jit_harness", "havoc", "-sf", str(seed),
            "-m", '{"seed": 3}', "-b", "512", "-o", str(out),
            "--device", "cpu", "-i",
            '{"target": "tlvstack_vm", "novelty": "throughput"}', *extra]


def test_campaign_stats_files(tmp_path):
    """A short default campaign writes fuzzer_stats, a monotone
    plot_data, stats.jsonl, an event log whose finds reconcile with
    the counters, and (with --trace) trace.json; --no-stats writes
    none of the stats files."""
    out = tmp_path / "out"
    assert main(_cli(out, "-n", str(20 * 512), "--stats-interval", "0",
                     "--trace")) == 0
    stats = tel.parse_fuzzer_stats(str(out / "fuzzer_stats"))
    assert int(stats["execs_done"]) == 20 * 512
    rows = [list(map(float, line.split(",")))
            for line in (out / "plot_data").read_text().splitlines()[1:]]
    assert len(rows) > 3 and rows[0][1] == 0
    for col in range(1, 8):              # cumulative columns
        assert all(b[col] >= a[col] for a, b in zip(rows, rows[1:]))
    assert rows[-1][1] == 20 * 512
    assert tel.read_latest_snapshot(str(out))["counters"]["execs"] \
        == 20 * 512
    events = list(tel.read_events(str(out)))
    count = {t: sum(e["type"] == t for e in events)
             for t in ("new_path", "crash", "hang", "scheduler_pick")}
    assert count["new_path"] == int(stats["paths_total"]) > 0
    assert count["crash"] == int(stats["unique_crashes"])
    assert count["hang"] == int(stats["unique_hangs"])
    assert count["scheduler_pick"] == 2     # boundaries at 8 and 16
    trace = json.loads((out / "trace.json").read_text())
    assert any(e.get("name") == "execute"
               for e in trace["traceEvents"])

    quiet = tmp_path / "quiet"
    assert main(_cli(quiet, "-n", "1024", "--no-stats")) == 0
    assert not any((quiet / n).exists() for n in (
        "fuzzer_stats", "plot_data", "stats.jsonl", "events.jsonl"))
    assert os.listdir(quiet / "new_paths")


# real CUDA runtime messages: a card that went away, and a kernel's own
# faults (bugs, which must stay crashes)
CARD_LOST = [
    "CUDA error: all CUDA-capable devices are busy or unavailable",
    "RuntimeError: No CUDA-capable device is detected",
    "CUDA error: uncorrectable ECC error encountered",
    "Unable to determine the device handle for GPU 0000:18:00.0: GPU "
    "has fallen off the bus",
    "CUDA error: system not yet initialized",
]
KERNEL_FAULT = [
    "CUDA error: an illegal memory access was encountered\nCUDA kernel "
    "errors might be asynchronously reported at some other API call",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered\nCompile with "
    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.",
    "CUDA error: misaligned address",
    "CUDA error: too many resources requested for launch",
]


@pytest.mark.parametrize("text", CARD_LOST)
def test_cuda_card_loss_is_device_loss(text):
    assert is_device_loss(text)
    assert is_device_loss(RuntimeError(text))


@pytest.mark.parametrize("text", KERNEL_FAULT)
def test_cuda_kernel_fault_is_a_crash(text):
    assert not is_device_loss(text)
    assert not is_device_loss(RuntimeError(text))


@pytest.mark.parametrize("text", [
    "XlaRuntimeError: INTERNAL", "DEVICE_LOST: slice gone",
    "TPU worker preempted", "ValueError: bad option",
    "assertion failed"])
def test_jax_markers_carried_over(text):
    assert is_device_loss(text) == jax_is_loss(text)


def test_device_loss_exits_87_after_a_checkpoint(tmp_path):
    out = tmp_path / "out"
    spec = json.dumps({"faults": [
        {"point": "device_dispatch", "mode": "raise", "hit": 2}]})
    try:
        rc = main(_cli(out, "-n", "4096", "-K", "1", "--chaos", spec,
                       "--corpus-dir", str(out / "corpus")))
    finally:
        chaos.configure(None)
    assert rc == DEVICE_LOST_EXIT_CODE
    assert (out / "corpus" / "checkpoint.json").exists()
    assert any(e["type"] == "device_lost"
               for e in tel.read_events(str(out)))


def test_watchdog_kills_a_hung_device_wait(tmp_path):
    """A ``device_wait`` hang from --chaos dies by the watchdog (exit
    86) within twice the armed deadline, leaving the stall event and
    the in-flight dump.  On the CPU a dispatch computes its batch, so
    the batches are tiny (target ``test``, 64 lanes, one thread) and
    the deadline's floor far above one, even on a loaded host."""
    out = tmp_path / "out"
    spec = json.dumps({"faults": [
        {"point": "device_wait", "mode": "hang", "hit": 2,
         "seconds": 60}]})
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "killerbeez_tpu_torch.fuzzer", "file",
         "jit_harness", "havoc", "-ss", "ABC@", "-m", '{"seed": 3}',
         "-b", "64", "-n", "1024", "-K", "1", "-o", str(out),
         "--device", "cpu", "-i", '{"target": "test"}', "--chaos", spec,
         "--watchdog", "4", "--watchdog-min", "5",
         "--watchdog-max", "15"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == WATCHDOG_EXIT_CODE, r.stderr[-2000:]
    stalls = [e for e in tel.read_events(str(out))
              if e["type"] == "watchdog_stall"]
    assert stalls and stalls[0]["stage"] == "host_transfer"
    assert stalls[0]["waited_s"] <= 2 * stalls[0]["deadline_s"]
    dump = json.loads((out / "watchdog_dump.json").read_text())
    assert dump["stage"] == "host_transfer"
    assert isinstance(dump["pending"], list)
