"""The device-resident generation loop (``-G``) of the port against the
JAX package's, on the CPU (the port's torch engine with the plain
versions; the JAX package's xla engine).  Each case mirrors one of
``tests/test_generations.py``:

  * the seed-slot pick (``_select_slot``, its host replay);
  * one ``run_batch_generations`` dispatch: every outcome field, the
    final ring and the three virgin maps, G in {1, 4}, reseeding on and
    off, exact and throughput novelty, on ``test`` and ``cgc_like``;
  * ``-fb 0 -G 4`` against the port's own host-driven loop, the partial
    last dispatch and the power-of-two tail, the ledger replayed into
    arms (no duplicates) against the JAX package's arms and
    ``ring_admit`` events, the ``-fb 0`` store write-through, counted
    findings-ring overflow, the stand-down, the watchdog's dispatch
    scale, the CLI's kill-mid-dispatch ``--resume`` convergence, the
    ``generations_per_dispatch`` gauge, ``--profile-device``, and both
    CLIs at ``-G 4`` on ``cgc_like`` at the default ``-fb``.

Tolerance: none (bytes and integer counters)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.drivers.factory import driver_factory as jax_driver
from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.instrumentation.factory import (
    instrumentation_factory as jax_instr,
)
from killerbeez_tpu.mutators.factory import mutator_factory as jax_mut
from killerbeez_tpu.ops.generations import _select_slot as jax_select
from killerbeez_tpu_torch.corpus.store import CorpusStore
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.ops.generations import (
    _select_slot, new_ring, np_select_slot, run_generations,
)
from killerbeez_tpu_torch.resilience.watchdog import DispatchWatchdog

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = b"ABC@"
CGC_SEED = b"CG\x02\x04\x05\x41xx"
SEEDS = {"test": SEED, "cgc_like": CGC_SEED}
MAPS = ("virgin_bits", "virgin_crash", "virgin_tmout")


def _parts(pkg, iopts, seed, mopts='{"seed": 7}'):
    """(instrumentation, mutator, driver) of one package on the CPU."""
    iopts = json.dumps(iopts)
    if pkg == "jax":
        instr = jax_instr("jit_harness", iopts)
        mut = jax_mut("havoc", mopts, seed)
        return instr, mut, jax_driver("file", None, instr, mut)
    instr = JitHarnessInstrumentation(iopts, device="cpu")
    mut = HavocMutator(mopts, seed, device="cpu")
    return instr, mut, driver_factory("file", None, instr, mut,
                                      device="cpu")


def _campaign(tmp_path, name, generations, *, pkg="torch", target="test",
              batch=64, n=1024, feedback=0, iopts=None, mopts='{"seed": 7}',
              watchdog=None, store=None):
    """One package's Fuzzer run; returns (fuzzer, instrumentation)."""
    instr, _, drv = _parts(pkg, iopts or {"target": target},
                           SEEDS.get(target, SEED), mopts)
    out = tmp_path / name
    store = bool(feedback) if store is None else store
    cls = JaxFuzzer if pkg == "jax" else Fuzzer
    fz = cls(drv, output_dir=str(out), batch_size=batch,
             feedback=feedback, generations=generations,
             corpus_dir=str(out / "corpus") if store else None,
             watchdog=watchdog)
    fz.run(n)
    return fz, instr


def _findings(root):
    return {kind: sorted(f for f in os.listdir(os.path.join(root, kind))
                         if len(f) == 32)
            for kind in ("crashes", "hangs", "new_paths")}


def _events(root):
    with open(os.path.join(root, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _ring_admits(root):
    return [(e["md5"], e["slot"], e["gen"], e["parent"])
            for e in _events(root) if e["type"] == "ring_admit"]


def _entries(corpus_dir):
    """Each stored entry's md5 and lineage parent."""
    return {e.md5: e.parent for e in CorpusStore(str(corpus_dir)).load()}


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b, what):
    a, b = _host(a), _host(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# the seed-slot pick and one dispatch
# ---------------------------------------------------------------------------


def test_select_slot_matches_jax():
    """The device pick, its host replay and the JAX package's pick agree
    on random ring occupancies and land on a filled slot."""
    rng = np.random.default_rng(5)
    for i in range(64):
        s = (2, 7, 32, 47)[i % 4]       # few shapes: JAX compiles each
        filled = np.zeros(s, np.int32)
        filled[0] = 1
        filled[rng.integers(0, s, size=int(rng.integers(0, s)))] = 1
        gen_id = int(rng.integers(0, 2**32))
        salt = int(rng.integers(0, 2**32))
        ref = int(jax_select(jnp.asarray(filled), jnp.uint32(gen_id),
                             jnp.uint32(salt)))
        got = _select_slot(torch.from_numpy(filled), gen_id, salt)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == np_select_slot(filled, gen_id, salt) == ref
        assert filled[ref] == 1


@pytest.mark.parametrize("novelty", ["exact", "throughput"])
@pytest.mark.parametrize("reseed", [True, False])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("target", ["test", "cgc_like"])
def test_dispatch_matches_jax(target, g, reseed, novelty):
    """``run_batch_generations``: every outcome field, the final ring
    and the virgin maps equal the JAX package's.  60 real lanes padded
    to 64 (lane-0 repeats); with G = 1 two dispatches, so the ring and
    the generation count carry from one to the next."""
    iopts = {"target": target, "novelty": novelty}
    ji, jm, _ = _parts("jax", iopts, SEEDS[target], '{"seed": 11}')
    ti, tm, _ = _parts("torch", iopts, SEEDS[target], '{"seed": 11}')
    n = 60
    for _ in range(2 if g == 1 else 1):
        ref = ji.run_batch_generations(jm, jm.peek_iterations(n), g,
                                       pad_to=64, reseed=reseed)
        got = ti.run_batch_generations(tm, tm.peek_iterations(n), g,
                                       pad_to=64, reseed=reseed)
        jm.advance(g * n)
        tm.advance(g * n)
        ref, got = ref.materialize(), got.materialize()
        for f in ref._fields:
            _equal(getattr(got, f), getattr(ref, f), f)
    for a, b, f in zip(ti._gen_ring.view(), ji._gen_ring,
                       ("bufs", "lens", "filled", "hits", "finds", "ptr")):
        _equal(a, b, f"ring {f}")
    for m in MAPS:
        _equal(getattr(ti, m), getattr(ji, m), m)
    assert ti.total_execs == ji.total_execs == n * g * (2 if g == 1 else 1)
    if reseed and target == "cgc_like":
        assert int(ref.ring_filled.sum()) > 1       # admissions happened


def _direct_dispatch(instr, mut, slots, adm_cap, reseed=True):
    """One G = 1 ``run_generations`` call made directly (no
    ``gen_ring_caps`` clamp) on a fresh ring of ``slots`` slots."""
    seed_buf, seed_len, base_key, sp = mut.fused_spec()
    ring = new_ring(seed_buf.to(instr.device), seed_len, slots)
    its = instr._its(mut.peek_iterations(64))
    p = instr.program
    return run_generations(
        instr._instrs, instr._edge_table, instr._u_slots, instr._seg_id,
        ring, base_key.to(instr.device), its, 64, 0, 0,
        instr.virgin_bits, instr.virgin_crash, instr.virgin_tmout,
        mem_size=p.mem_size, max_steps=p.max_steps, n_edges=p.n_edges,
        exact=False, stack_pow2=int(sp), g=1, reseed=reseed,
        adm_cap=adm_cap, findings_cap=64)


def test_run_generations_refuses_admissions_past_the_ring():
    """An admission cap above the ring's S - 1 admission slots would
    repeat a slot in one scatter (no defined winner on the card): the
    dispatch refuses it with the mesh's wording; S - 1 runs, and so does
    any cap with reseeding off (the ledger keeps one row)."""
    ti, tm, _ = _parts("torch", {"target": "cgc_like"}, CGC_SEED)
    with pytest.raises(ValueError, match="adm_cap 8 exceeds the ring's "
                       "7 admission slots"):
        _direct_dispatch(ti, tm, 8, 8)
    _, ring, _ = _direct_dispatch(ti, tm, 8, 7)
    assert ring.slots == 8
    _direct_dispatch(ti, tm, 8, 8, reseed=False)


# ---------------------------------------------------------------------------
# the loop: determinism, tails, admission replay, store, overflow
# ---------------------------------------------------------------------------


def test_fb0_generations_match_host_loop(tmp_path):
    """With reseeding off (-fb 0) the generation loop consumes the host
    loop's candidate stream: the same findings and virgin maps."""
    fh, ih = _campaign(tmp_path, "host", 0)
    fg, ig = _campaign(tmp_path, "gen", 4)
    assert fg.stats.iterations == fh.stats.iterations == 1024
    assert _findings(tmp_path / "gen") == _findings(tmp_path / "host")
    assert fg.stats.as_dict()["crashes"] == fh.stats.crashes
    assert fg.stats.new_paths == fh.stats.new_paths >= 1
    for m in MAPS:
        assert torch.equal(getattr(ig, m), getattr(ih, m)), m


class _RecordingWatchdog(DispatchWatchdog):
    """A real watchdog (huge deadlines — never fires) that records
    every note_dispatch_scale call the loop makes."""

    def __init__(self):
        super().__init__(multiplier=1e6, min_deadline=1e6,
                         max_deadline=1e6)
        self.scales = []

    def note_dispatch_scale(self, k):
        self.scales.append(int(k))
        super().note_dispatch_scale(k)


@pytest.mark.parametrize("g,n,scales", [
    (4, 64 * 5, [4, 1, 4, 1, 1]),            # one g=4 dispatch + a g=1 tail
    (8, 64 * 11, [8, 2, 8, 1, 2, 1, 1]),     # 8 + (3 -> 2) + 1
    (8, 640, [8, 2, 8, 2, 1]),               # 10 batches: 8 + 2
])
def test_partial_last_dispatch_and_pow2_tail(g, n, scales, tmp_path):
    """-n not divisible by G x batch: the exec total stays exact, tails
    quantize the generation count down to a power of two, and each
    drain arms the watchdog with the DRAINED dispatch's own count (a
    g = 1 tail queued behind a full dispatch must not clamp the full
    dispatch's wait to one batch)."""
    wd = _RecordingWatchdog()
    try:
        fz, _ = _campaign(tmp_path, "o", g, n=n, watchdog=wd)
    finally:
        wd.stop()
    assert fz.stats.iterations == n
    assert wd.scales == scales
    assert all(k & (k - 1) == 0 for k in wd.scales)


def test_ring_admissions_replay_into_arms_as_jax(tmp_path):
    """Feedback on: the device ledger replays through the admission
    stage into arms (no duplicates), one ring_admit event each, every
    one a store entry in a slot >= 1 — and the arms, events, store
    entries, findings and counters are the JAX package's."""
    kw = dict(target="cgc_like", batch=256, n=4096, feedback=8,
              mopts='{"seed": 11}')
    ref, _ = _campaign(tmp_path, "jax", 4, pkg="jax", **kw)
    got, _ = _campaign(tmp_path, "torch", 4, **kw)
    arms = [a.md5 for a in got.scheduler.arms]
    assert arms == [a.md5 for a in ref.scheduler.arms]
    assert len(arms) == len(set(arms))
    admits = _ring_admits(tmp_path / "torch")
    assert admits and admits == _ring_admits(tmp_path / "jax")
    entries = _entries(tmp_path / "torch" / "corpus")
    assert entries == _entries(tmp_path / "jax" / "corpus")
    assert all(md5 in entries and slot >= 1
               for md5, slot, _, _ in admits)
    assert any(parent != "base" for *_, parent in admits)
    assert _findings(tmp_path / "torch") == _findings(tmp_path / "jax")
    for f in ("iterations", "crashes", "hangs", "new_paths",
              "unique_crashes", "unique_hangs"):
        assert getattr(got.stats, f) == getattr(ref.stats, f), f
    assert [a[2] for a in got.scheduler.arms] == \
        [a[2] for a in ref.scheduler.arms]          # no replay credit


def test_fb0_store_write_through_matches_host(tmp_path):
    """-fb 0 with a corpus store: the device ledger is empty, so the
    drain admits edge-novel ring lanes host-side — the store holds the
    host loop's entries (and the JAX package's under -G)."""
    for name, gens, pkg in (("host", 0, "torch"), ("gen", 4, "torch"),
                            ("jax", 4, "jax")):
        _campaign(tmp_path, name, gens, pkg=pkg, store=True)

    def names(name):
        return sorted(_entries(tmp_path / name / "corpus"))
    assert names("gen") == names("host") == names("jax")
    assert names("gen"), "store stayed empty — nothing compared"


def test_findings_ring_overflow_counted_as_jax(tmp_path):
    """gen_findings_cap=2 on a findings-heavy target: the ring
    overflows, and every dropped lane is counted, as in JAX."""
    kw = dict(iopts={"target": "test", "gen_findings_cap": 2}, n=512)
    got, _ = _campaign(tmp_path, "torch", 4, **kw)
    ref, _ = _campaign(tmp_path, "jax", 4, pkg="jax", **kw)
    drops = got.telemetry.registry.counters.get("findings_ring_drops", 0)
    assert drops > 0
    assert drops == ref.telemetry.registry.counters["findings_ring_drops"]
    assert _findings(tmp_path / "torch") == _findings(tmp_path / "jax")


def test_stands_down_without_fused_spec(tmp_path):
    """A mutator with no fused candidate spec (or a focus mask) cannot
    run the device loop: -G stands down to the host-driven loop with a
    warning and still completes."""
    instr, mut, drv = _parts("torch", {"target": "test"}, SEED)
    assert drv.supports_batch_generations()
    mut.focus_positions = np.array([0, 1], np.int32)
    assert not drv.supports_batch_generations()
    mut.focus_positions = None
    mut.fused_spec = None
    assert not drv.supports_batch_generations()
    fz = Fuzzer(drv, output_dir=str(tmp_path / "o"), batch_size=64,
                feedback=0, generations=4)
    fz.run(256)
    assert fz._gen_warned and fz.stats.iterations == 256
    assert instr._gen_count == 0        # no dispatch ran


# ---------------------------------------------------------------------------
# watchdog scaling (no false-positive exit 86 under -G)
# ---------------------------------------------------------------------------


def test_watchdog_deadline_scales_with_generation_count():
    wd = DispatchWatchdog(multiplier=4.0, min_deadline=0.05,
                          max_deadline=100.0)
    wd._ema_batch_s = 0.5                       # warm estimate
    base = wd.deadline()
    assert base == pytest.approx(2.0)
    wd.note_dispatch_scale(16)
    assert wd.deadline() == pytest.approx(16 * base)
    # the ceiling scales too: a large G is not clamped back to a
    # one-batch budget
    wd2 = DispatchWatchdog(multiplier=4.0, min_deadline=0.05,
                           max_deadline=1.0)
    wd2._ema_batch_s = 0.5
    wd2.note_dispatch_scale(64)
    assert wd2.deadline() == pytest.approx(64.0)
    # cold start grants the (scaled) ceiling
    wd3 = DispatchWatchdog(min_deadline=0.05, max_deadline=2.0)
    wd3.note_dispatch_scale(8)
    assert wd3.deadline() == pytest.approx(16.0)


def test_watchdog_ema_stays_per_batch_across_scales():
    """A guarded wait folds into the EMA divided by its armed scale."""
    wd = DispatchWatchdog(multiplier=4.0, min_deadline=0.01,
                          max_deadline=100.0)
    wd.note_dispatch_scale(10)
    wd._arm("dispatch")
    time.sleep(0.2)                 # a "10-generation" wait
    wd._disarm()
    wd.stop()
    assert 0.0 < wd._ema_batch_s < 0.1


def test_watchdog_no_false_positive_on_scaled_dispatch():
    """A G-generation dispatch waits ~G x one batch: unscaled, this
    guard blows its deadline; with note_dispatch_scale(G) it must not."""
    fired = threading.Event()
    wd = DispatchWatchdog(multiplier=2.0, min_deadline=0.1,
                          max_deadline=60.0, action=fired.set)
    wd._ema_batch_s = 0.1           # warm: one batch ~ 0.1s
    assert wd.deadline() == pytest.approx(0.2)
    wd.note_dispatch_scale(8)
    try:
        with wd.guard("dispatch"):
            time.sleep(1.0)         # ~5x the UNSCALED deadline
        assert not fired.is_set()
    finally:
        wd.stop()
    assert wd.stalls == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_args(out, extra=()):
    return ["file", "jit_harness", "havoc", "-i", '{"target": "cgc_like"}',
            "-m", '{"seed": 11}', "-fb", "0", "-sf", "seed.bin", "-o", out,
            "-b", "256", "-n", "1024", "--corpus-dir",
            os.path.join(out, "corpus"), "--device", "cpu", *extra]


def _run_cli(tmp_path, args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    (tmp_path / "seed.bin").write_bytes(b"\x00" * 8)
    return subprocess.run(
        [sys.executable, "-m", "killerbeez_tpu_torch.fuzzer", *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=timeout)


def test_cli_kill_mid_dispatch_resume_converges(tmp_path):
    """SIGKILL while draining a G-generation dispatch, then --resume:
    the campaign converges to the fault-free control's findings, which
    the host-driven loop with the same seed finds too; the event log's
    seq stays monotone across the kill."""
    r = _run_cli(tmp_path, _cli_args("ctl_host"))
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run_cli(tmp_path, _cli_args("ctl_gen", ["-G", "4"]))
    assert r.returncode == 0, r.stderr[-2000:]
    control = _findings(tmp_path / "ctl_host")
    assert any(control.values()), "control found nothing to compare"
    assert _findings(tmp_path / "ctl_gen") == control
    spec = json.dumps({"faults": [
        {"point": "device_wait", "mode": "kill", "hit": 1}]})
    r = _run_cli(tmp_path, _cli_args("out", ["-G", "4", "--chaos", spec]))
    assert r.returncode == -signal.SIGKILL
    r = _run_cli(tmp_path, _cli_args("out", ["-G", "4", "--resume"]))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _findings(tmp_path / "out") == control
    seqs = [e["seq"] for e in _events(tmp_path / "out")]
    assert seqs and all(b > a for a, b in zip(seqs, seqs[1:]))


def test_cli_generations_gauge_and_profile_device(tmp_path):
    """The stats snapshot carries generations_per_dispatch = 4, and
    --profile-device (bare: 8 generations) writes a Chrome trace of the
    first two dispatches while the run completes."""
    (tmp_path / "seed.bin").write_bytes(b"\x00" * 8)
    out = str(tmp_path / "out")
    args = _cli_args(out, ["-G", "4", "--stats-interval", "0.1",
                           "--profile-device"])
    args[args.index("-sf") + 1] = str(tmp_path / "seed.bin")
    assert main(args) == 0
    with open(os.path.join(out, "stats.jsonl")) as f:
        snap = [json.loads(line) for line in f if line.strip()][-1]
    assert snap["gauges"].get("generations_per_dispatch") == 4
    assert snap["counters"]["execs"] == 1024
    with open(os.path.join(out, "device_trace", "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_cli_generations_match_jax(tmp_path):
    """Both CLIs at -G 4 -b 256 on cgc_like at the default -fb (device
    reseeding on): the same md5 sets, ring_admit sequence, store
    entries, -isd state and fuzzer_stats counters."""
    seed = tmp_path / "seed.bin"
    seed.write_bytes(CGC_SEED)
    got = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        engine = "xla" if pkg == "jax" else "torch"
        argv = ["file", "jit_harness", "havoc", "-sf", str(seed),
                "-m", '{"seed": 11}', "-b", "256", "-n", "4096", "-G", "4",
                "-o", str(out), "-i",
                json.dumps({"target": "cgc_like", "engine": engine}),
                "--corpus-dir", str(out / "corpus"), "-isd", f"{out}.isd"]
        rc = jax_main(argv) if pkg == "jax" else \
            main(argv + ["--device", "cpu"])
        assert rc == 0
        with open(out / "fuzzer_stats") as f:
            stats = dict(line.split(":", 1) for line in f)
        got[pkg] = {
            "findings": _findings(out), "admits": _ring_admits(out),
            "entries": _entries(out / "corpus"),
            "isd": open(f"{out}.isd").read(),
            "counters": {k.strip(): v.strip() for k, v in stats.items()
                         if k.strip() in ("execs_done", "paths_total",
                                          "unique_crashes",
                                          "unique_hangs")}}
    assert got["torch"] == got["jax"]
    assert got["torch"]["admits"] and got["torch"]["counters"][
        "execs_done"] == "4096"
