"""The port's mesh-resident generations (``make_sharded_generations``,
``-G`` on ``--mesh``) against the JAX package's, on the CPU.  Each case
mirrors one of ``tests/test_mesh_generations.py``; the JAX package runs
its xla engine on the virtual 8-device CPU mesh, the port runs on
``["cpu"] * n``:

  * one dispatch builder per mesh shape (1,1), (2,1), (4,2), (1,2): a
    G = 4 dispatch with reseeding and a fold every 2 generations, then
    one without reseeding at the auto cadence (every generation), and
    at (4,2) a G = 2 dispatch asking a fold every 3 (lowered to 2):
    every ring and ledger field, the rings and the three virgin maps;
  * both CLIs at ``--mesh 4,2 -G 4`` (md5 sets, ``-isd``, ``ring_admit``
    events, store entries), and the port's ``-G 4 -fb 0`` against its
    host-driven ``-fb 0`` mesh loop;
  * the fold cadence's over-report, the power-of-two tail, the
    findings ring at exactly its capacity, the per-shard ledger replay
    against the JAX package's, and dp = 1 through the shard view.

JAX's per-shard kb-timeline test is not mirrored: the tools are not
ported.  Tolerance: none (bytes and integer counters)."""

import json
import os

import numpy as np
import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.instrumentation.factory import (
    instrumentation_factory as jax_instr,
)
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.mutators.factory import mutator_factory as jax_mut
from killerbeez_tpu.parallel import ShardedCampaignDriver as JaxDriver
from killerbeez_tpu.parallel import make_mesh as jax_mesh
from killerbeez_tpu.parallel import make_sharded_generations as jax_gens
from killerbeez_tpu.parallel import sharded_gen_ring_init as jax_ring
from killerbeez_tpu.parallel import sharded_state_init as jax_init
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.parallel import (
    ShardedCampaignDriver, make_mesh, make_sharded_generations,
    sharded_gen_ring_init, sharded_state_init,
)
from killerbeez_tpu_torch.resilience.watchdog import DispatchWatchdog

torch.set_num_threads(1)

SEED = b"CG\x02\x04\x05\x41xx"
SHAPES = [(1, 1), (2, 1), (4, 2), (1, 2)]
BPD, L, SLOTS = 16, 16, 8
MESH = "4,2"
B = 64                                  # 16 lanes per dp shard at dp=4
MAPS = ("virgin_bits", "virgin_crash", "virgin_tmout")
RING = ("bufs", "lens", "filled", "hits", "finds", "ptr")
REPORT = ("fr_pack", "fr_gen", "fr_iter", "fr_len", "fr_bufs", "fr_ptr",
          "sel", "adm_raw", "adm_valid", "adm_slot", "adm_iter", "adm_len",
          "adm_bufs")
#: (g, reseed, fold_every) of each dispatch, in order
DISPATCHES = [(4, True, 2), (4, False, 0)]
FOLD3 = (2, True, 3)


def _seed_buf():
    buf = np.zeros(L, dtype=np.uint8)
    buf[:len(SEED)] = np.frombuffer(SEED, dtype=np.uint8)
    return buf


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def _schedule(shape):
    return DISPATCHES + ([FOLD3] if shape == (4, 2) else [])


def _run(pkg, shape):
    """One package's dispatches on ``shape``: per dispatch (report
    fields, ring fields, maps)."""
    n_dp, n_mp = shape
    buf = _seed_buf()
    kw = dict(max_len=L, seed=11, salt=11, adm_cap=4, findings_cap=24)
    if pkg == "jax":
        prog = jax_targets.get_target("cgc_like")
        mesh = jax_mesh(n_dp, n_mp)
        dispatch = jax_gens(prog, mesh, BPD, **kw)
        st, ring = jax_init(mesh, prog.map_size), jax_ring(
            mesh, buf, len(SEED), SLOTS, L)
    else:
        prog = get_target("cgc_like")
        mesh = make_mesh(n_dp, n_mp, ["cpu"] * (n_dp * n_mp))
        dispatch = make_sharded_generations(prog, mesh, BPD,
                                            engine=pkg, **kw)
        st, ring = sharded_state_init(mesh, prog.map_size), \
            sharded_gen_ring_init(mesh, buf, len(SEED), SLOTS, L)
    out, gen0 = [], 0
    for g, reseed, fold in _schedule(shape):
        st, ring, rep = dispatch(st, ring, gen0 * BPD * n_dp, gen0, g,
                                 reseed=reseed, fold_every=fold)
        rings = [getattr(ring, f) if pkg == "jax" else ring.field(f)
                 for f in RING]
        maps = [getattr(st, m) if pkg == "jax" else st.full_map(m)
                for m in MAPS]
        out.append(([_np(a) for a in rep], [_np(a) for a in rings],
                    [_np(a) for a in maps]))
        gen0 += g
    return out


@pytest.fixture(scope="module")
def jax_dispatches():
    return {shape: _run("jax", shape) for shape in SHAPES}


@pytest.mark.parametrize("engine", ["torch", "cuda_fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dispatch_matches_jax(shape, engine, jax_dispatches):
    """Every report field, the per-shard rings and the folded maps after
    each dispatch equal the JAX package's."""
    got = _run(engine, shape)
    for i, (mine, ref) in enumerate(zip(got, jax_dispatches[shape])):
        for names, a_all, b_all in zip((REPORT, RING, MAPS), mine, ref):
            for f, a, b in zip(names, a_all, b_all):
                _equal(a, b, f"dispatch {i} {f}")
    # the ring admitted and the findings ring saw lanes on every shape
    assert got[0][1][2].sum() > shape[0]
    assert got[0][0][5].sum() > 0


def test_tiers_not_ported_are_refused():
    """Every tier is ported now: learn and grammar take the torch and
    cuda engines, never the fused kernel, and a learn dispatch needs
    the weights; sessions take torch."""
    from killerbeez_tpu_torch.grammar.tables import degenerate_tables
    prog = get_target("cgc_like")
    mesh = make_mesh(1, 1, ["cpu"])
    with pytest.raises(ValueError, match="needs the torch or cuda engine"):
        make_sharded_generations(prog, mesh, 8, 16, engine="cuda_fused",
                                 learn=True)
    dispatch = make_sharded_generations(prog, mesh, 8, 16, learn=True)
    with pytest.raises(ValueError, match="pass the model weights"):
        dispatch(None, None, 0, 0, 1)
    with pytest.raises(ValueError, match="torch or cuda engine"):
        make_sharded_generations(prog, mesh, 8, 16, engine="cuda_fused",
                                 grammar=degenerate_tables())
    make_sharded_generations(prog, mesh, 8, 16,
                             grammar=degenerate_tables())
    with pytest.raises(ValueError, match="stateful mesh campaigns need "
                       "the torch engine"):
        make_sharded_generations(prog, mesh, 8, 16, engine="cuda_fused",
                                 stateful=(4, 8, 0))
    make_sharded_generations(prog, mesh, 8, 16, stateful=(4, 8, 0))


# ---------------------------------------------------------------------------
# the campaign: both CLIs, and -G against the host-driven mesh loop
# ---------------------------------------------------------------------------


def _findings(root):
    return {kind: sorted(f for f in os.listdir(os.path.join(root, kind))
                         if len(f) == 32)
            for kind in ("crashes", "hangs", "new_paths")}


def _events(root):
    with open(os.path.join(root, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _admits(root):
    return [(e["shard"], e["slot"], e["gen"], e["md5"], e["parent"])
            for e in _events(root) if e["type"] == "ring_admit"]


def _store(root):
    return sorted(f for f in os.listdir(os.path.join(root, "corpus"))
                  if len(f) == 32)


def _cli(fn, tmp_path, name, *extra):
    seed = tmp_path / "seed"
    seed.write_bytes(SEED)
    out = tmp_path / name
    rc = fn(["file", "jit_harness", "havoc", "--mesh", MESH, "-i",
             '{"target": "cgc_like"}', "-m", '{"seed": 11}', "-sf",
             str(seed), "-o", str(out), "-b", str(B), "--corpus-dir",
             str(out / "corpus"), "-isd", str(tmp_path / f"{name}.isd"),
             *extra])
    assert rc == 0
    return (_findings(out), (tmp_path / f"{name}.isd").read_text(),
            _store(out), out)


def test_cli_mesh_generations_match_jax(tmp_path):
    """Both CLIs at --mesh 4,2 -G 4 with the default -fb (device ring
    reseeding on): the same findings, state, ring admissions (shard,
    slot, generation, md5, parent) and store entries."""
    ref = _cli(jax_main, tmp_path, "jax", "-n", str(16 * B), "-G", "4")
    got = _cli(main, tmp_path, "torch", "-n", str(16 * B), "-G", "4",
               "--device", "cpu")
    assert got[:3] == ref[:3]
    admits = _admits(got[3])
    assert admits and admits == _admits(ref[3])
    assert {s for s, *_ in admits} == {0, 1, 2, 3}


def test_mesh_generations_match_host_mesh_loop(tmp_path):
    """With feedback off the port's mesh generations consume the
    host-driven mesh loop's candidate stream: findings, folded maps and
    the store write-through are equal."""
    host = _cli(main, tmp_path, "host", "-n", str(8 * B), "-fb", "0",
                "--device", "cpu")
    gen = _cli(main, tmp_path, "gen", "-n", str(8 * B), "-fb", "0", "-G",
               "4", "--device", "cpu")
    assert any(host[0].values())
    assert gen[:3] == host[:3] and host[2]
    assert json.loads(gen[1])["total_execs"] == 8 * B


# ---------------------------------------------------------------------------
# fold cadence, tails, the findings ring, the ledger replay
# ---------------------------------------------------------------------------


def _driver(iopts=None, batch=B, mesh=MESH, pkg="torch"):
    iopts = iopts or '{"target": "cgc_like"}'
    if pkg == "jax":
        instr = jax_instr("jit_harness", iopts)
        mut = jax_mut("havoc", '{"seed": 11}', SEED)
        return JaxDriver(mesh, instr, mut, batch_size=batch)
    instr = JitHarnessInstrumentation(iopts, device="cpu")
    mut = HavocMutator('{"seed": 11}', SEED, device="cpu")
    return ShardedCampaignDriver(mesh, instr, mut, batch_size=batch)


def _ring_bufs(h):
    out = set()
    for d in range(h.n_shards):
        s = h.shard(d)
        for i in range(min(int(s.fr_ptr), int(s.cap))):
            out.add(bytes(s.fr_bufs[i, :int(s.fr_len[i])]))
    return out


def test_fold_cadence_over_reports_never_under_reports():
    """A sparser fold re-finds other shards' paths between folds, never
    fewer findings, and the folded maps end identical."""
    outs = {}
    for fe in (1, 4):
        drv = _driver(json.dumps({"target": "cgc_like",
                                  "gen_fold_every": fe}))
        assert drv.supports_batch_generations()
        h = drv.test_batch_generations(B, 4, reseed=False).materialize()
        outs[fe] = (h, [drv.state.full_map(m) for m in MAPS])
    a, b = outs[1], outs[4]
    assert a[0].n_shards == 4
    assert int(b[0].fr_ptr.sum()) >= int(a[0].fr_ptr.sum())
    assert _ring_bufs(a[0]) <= _ring_bufs(b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


class _RecordingWatchdog(DispatchWatchdog):
    """A watchdog that never fires and records the dispatch scales."""

    def __init__(self):
        super().__init__(multiplier=1e6, min_deadline=1e6,
                         max_deadline=1e6)
        self.scales = []

    def note_dispatch_scale(self, k):
        self.scales.append(int(k))
        super().note_dispatch_scale(k)


def test_tail_quantizes_to_pow2_and_execs_exact(tmp_path):
    """-n not filling G x b: tails quantize G down to a power of two,
    the exec total stays exact, the mode never stands down, and a tail
    below the mesh batch stops with a warning."""
    wd = _RecordingWatchdog()
    fz = Fuzzer(_driver(), output_dir=str(tmp_path / "o"), batch_size=B,
                feedback=0, generations=8, watchdog=wd)
    try:
        fz.run(B * 11 + B // 2)     # 8 + (3 -> 2) + 1, then half a batch
    finally:
        wd.stop()
    assert fz.stats.iterations == B * 11
    assert not fz._gen_warned
    assert all(k & (k - 1) == 0 for k in wd.scales), wd.scales
    assert wd.scales[:2] == [8, 2]


def test_findings_ring_wrap_exactly_at_capacity(tmp_path):
    """Per shard: a capacity equal to the busiest shard's interesting
    count loses nothing; one less drops exactly the excess into
    findings_ring_drops."""
    h = _driver().test_batch_generations(B, 4, reseed=False).materialize()
    raw = [int(p) for p in h.fr_ptr]
    top = max(raw)
    assert top >= 2

    def run_with_cap(name, cap):
        drv = _driver(json.dumps({"target": "cgc_like",
                                  "gen_findings_cap": cap}))
        fz = Fuzzer(drv, output_dir=str(tmp_path / name), batch_size=B,
                    feedback=0, generations=4)
        fz.run(4 * B)       # exactly one dispatch
        return fz.telemetry.registry.counters.get("findings_ring_drops", 0)

    assert run_with_cap("exact", top) == 0
    assert run_with_cap("minus1", top - 1) == \
        sum(r - min(r, top - 1) for r in raw)
    assert len(_findings(str(tmp_path / "minus1"))["new_paths"]) <= \
        len(_findings(str(tmp_path / "exact"))["new_paths"])


def test_ledger_replay_per_shard_matches_jax(tmp_path):
    """Feedback on at dp = 4: the device ring admissions replay through
    (shard, slot)-keyed mirrors in shard order; the admissions, the
    findings and the arms equal the JAX package's, every shard admits,
    and every admission is a store entry."""
    runs = {}
    for pkg, cls in (("jax", JaxFuzzer), ("torch", Fuzzer)):
        out = tmp_path / pkg
        fz = cls(_driver(batch=256, pkg=pkg), output_dir=str(out),
                 batch_size=256, feedback=8, generations=4,
                 corpus_dir=str(out / "corpus"))
        fz.run(2048)
        runs[pkg] = (fz, _admits(out), _findings(out))
    fz, admits, found = runs["torch"]
    assert admits and admits == runs["jax"][1]
    assert found == runs["jax"][2]
    assert {s for s, *_ in admits} == {0, 1, 2, 3}
    for _, slot, _, md5, _ in admits:
        assert slot >= 1 and (tmp_path / "torch" / "corpus" / md5).exists()
    md5s = [a.md5 for a in fz.scheduler.arms]
    assert md5s == [a.md5 for a in runs["jax"][0].scheduler.arms]
    assert len(md5s) == len(set(md5s))


def test_dp1_mesh_generations_drain_through_shard_view(tmp_path):
    """A dp = 1 mesh report still has the leading dp axis on every
    field: the drain goes through shard(0), never the single-device
    path."""
    fz = Fuzzer(_driver(mesh="1,2"), output_dir=str(tmp_path / "o"),
                batch_size=B, feedback=8, generations=4,
                corpus_dir=str(tmp_path / "o" / "corpus"))
    fz.run(8 * B)
    assert fz.stats.iterations == 8 * B
    assert not fz._gen_warned
    assert fz.stats.new_paths > 0


def test_admissions_must_fit_the_ring():
    """More admissions per generation than the ring's S-1 slots would
    scatter two lanes into one slot (no defined winner on the card):
    the dispatch refuses; gen_ring_caps clamps the campaign's cap."""
    prog = get_target("cgc_like")
    mesh = make_mesh(2, 1, ["cpu"] * 2)
    dispatch = make_sharded_generations(prog, mesh, 8, L, adm_cap=8)
    st = sharded_state_init(mesh, prog.map_size)
    ring = sharded_gen_ring_init(mesh, _seed_buf(), len(SEED), 8, L)
    with pytest.raises(ValueError, match="admission slots"):
        dispatch(st, ring, 0, 0, 2)
    dispatch(st, ring, 0, 0, 2, reseed=False)   # one ledger row fits
