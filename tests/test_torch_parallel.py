"""The port's mesh tier (``killerbeez_tpu_torch/parallel``) against the
JAX package's, on the CPU.  Each case mirrors one of
``tests/test_parallel.py``: the JAX package runs its xla engine on the
virtual 8-device CPU mesh (``tests/conftest.py``), the port runs on
``["cpu"] * n`` with each of its engines (on CPU tensors the kernels'
wrappers take their plain versions), and the same numpy-made inputs
must give identical bits:

  * mesh construction, the too-few-devices error, mp dividing the map;
  * ``step`` (three steps, the third past 2**32) and ``step.multi`` at
    (dp, mp) = (1,1), (2,1), (4,2) and (1,2): statuses, rets, uc, uh,
    exit codes, candidates, lengths, the compact report (padded rows
    too) and the three virgin maps;
  * mesh-shape invariance, the 64-bit counter, the cross-dp
    over-report, unique crash flags, the superbatch against sequential
    steps, the single-device triage reference, a two-module program;
  * the CLI's ``--mesh 4,2`` campaign on ``--device cpu`` against the
    JAX CLI (md5 sets, ``-isd``, counters, the mesh gauges), and the
    port's state dump through the JAX package's merger.

Tolerance: none (bytes and integer counters)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.instrumentation.factory import (
    instrumentation_factory as jax_instr,
)
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.parallel import make_mesh as jax_mesh
from killerbeez_tpu.parallel import make_sharded_fuzz_step as jax_step
from killerbeez_tpu.parallel import sharded_state_init as jax_init
from killerbeez_tpu.tools.merger import merge_state_files
from killerbeez_tpu_torch import FUZZ_CRASH, MAP_SIZE
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.instrumentation.base import pack_verdicts
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.ops.static_triage import (
    make_static_maps, static_triage,
)
from killerbeez_tpu_torch.ops.vm_kernel import fuzz_batch_plain, seed_ring
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.parallel import (
    make_mesh, make_sharded_fuzz_step, sharded_state_init,
)
from killerbeez_tpu_torch.telemetry import (
    parse_fuzzer_stats, read_latest_snapshot,
)

torch.set_num_threads(1)

SEED = b"CG\x02\x04\x05\x41xx"
SHAPES = [(1, 1), (2, 1), (4, 2), (1, 2)]
BPD, L, K = 16, 16, 3
MAPS = ("virgin_bits", "virgin_crash", "virgin_tmout")
FIELDS = ("statuses", "rets", "uc", "uh", "exit_codes", "bufs", "lens")


def _seed_buf(seed=SEED, size=L):
    buf = np.zeros(size, dtype=np.uint8)
    buf[:len(seed)] = np.frombuffer(seed, dtype=np.uint8)
    return buf


def _bases(n_dp):
    """Three steps' counters: 0, one global batch on, and one past
    2**32 (both uint32 halves fold)."""
    b = BPD * n_dp
    return (0, b, (1 << 32) + 2 * b)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def _jax_maps(state):
    return [np.asarray(getattr(state, m)) for m in MAPS]


def _port_maps(state):
    return [state.full_map(m) for m in MAPS]


def _torch_mesh(n_dp, n_mp):
    return make_mesh(n_dp, n_mp, ["cpu"] * (n_dp * n_mp))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's mesh step per shape: three steps from fresh
    maps (outputs, compact report, maps after each), then a K = 3
    superbatch from there."""
    prog = jax_targets.get_target("cgc_like")
    buf, n = jnp.asarray(_seed_buf()), jnp.int32(len(SEED))
    out = {}
    for n_dp, n_mp in SHAPES:
        mesh = jax_mesh(n_dp, n_mp)
        step = jax_step(prog, mesh, batch_per_device=BPD, max_len=L)
        st = jax_init(mesh, prog.map_size)
        steps = []
        for base in _bases(n_dp):
            st, *r = step(st, buf, n, base)
            steps.append(([np.asarray(a) for a in r[:7]],
                          [np.asarray(a) for a in r[7]], _jax_maps(st)))
        st, packed, bufs, lens, compact = step.multi(st, buf, n, 12345, K)
        multi = ([np.asarray(a) for a in (packed, bufs, lens)],
                 [np.asarray(a) for a in compact], _jax_maps(st))
        out[(n_dp, n_mp)] = (steps, multi)
    return out


def _port_step(n_dp, n_mp, engine="torch", bpd=BPD, target="cgc_like",
               max_len=L):
    prog = get_target(target)
    mesh = _torch_mesh(n_dp, n_mp)
    step = make_sharded_fuzz_step(prog, mesh, batch_per_device=bpd,
                                  max_len=max_len, engine=engine)
    return step, sharded_state_init(mesh, prog.map_size)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def test_mesh_construction(monkeypatch):
    mesh = make_mesh(4, 2, ["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "mp": 2}
    assert mesh.devices[3][1] == torch.device("cpu")
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        make_mesh(16, 1, ["cpu"] * 8)
    # with no device list the mesh takes CUDA cards, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_mesh(2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        make_mesh(4, 2)
    assert make_mesh(1, 1).devices == ((torch.device("cuda:0"),),)


def test_mp_must_divide_map_and_engines_are_named():
    prog = get_target("test")
    with pytest.raises(ValueError, match="divide"):
        make_sharded_fuzz_step(prog, _torch_mesh(2, 3), 8, 16)
    with pytest.raises(ValueError, match="unknown engine 'xla'"):
        make_sharded_fuzz_step(prog, _torch_mesh(1, 1), 8, 16,
                               engine="xla")
    with pytest.raises(ValueError, match="stateful mesh campaigns need "
                       "the torch engine"):
        make_sharded_fuzz_step(prog, _torch_mesh(1, 1), 8, 16,
                               engine="cuda", stateful=(4, 8, 0))
    make_sharded_fuzz_step(prog, _torch_mesh(1, 1), 8, 16,
                           stateful=(4, 8, 0))


# ---------------------------------------------------------------------------
# step and step.multi against the JAX mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["torch", "cuda", "cuda_fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_matches_jax(shape, engine, jax_runs):
    """Three steps, every output, the compact report and the maps."""
    step, st = _port_step(*shape, engine=engine)
    buf = torch.from_numpy(_seed_buf())
    for i, base in enumerate(_bases(shape[0])):
        st, *r = step(st, buf, len(SEED), base)
        ref_out, ref_compact, ref_maps = jax_runs[shape][0][i]
        for f, a, b in zip(FIELDS, r[:7], ref_out):
            _equal(a, b, f"step {i} {f}")
        for f, a, b in zip(("idx", "bufs", "lens", "count"), r[7],
                           ref_compact):
            _equal(a, b, f"step {i} compact {f}")
        for f, a, b in zip(MAPS, _port_maps(st), ref_maps):
            _equal(a, b, f"step {i} {f}")
    assert st.step == 3


@pytest.mark.parametrize("engine", ["torch", "cuda_fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_multi_matches_jax(shape, engine, jax_runs):
    """A K = 3 superbatch after the three steps: packed verdicts,
    candidates, the stacked compact report and the maps."""
    step, st = _port_step(*shape, engine=engine)
    buf = torch.from_numpy(_seed_buf())
    for base in _bases(shape[0]):
        st = step(st, buf, len(SEED), base)[0]
    st, packed, bufs, lens, compact = step.multi(st, buf, len(SEED), 12345,
                                                 K)
    ref_out, ref_compact, ref_maps = jax_runs[shape][1]
    for f, a, b in zip(("packed", "bufs", "lens"), (packed, bufs, lens),
                       ref_out):
        _equal(a, b, f"multi {f}")
    for f, a, b in zip(("idx", "bufs", "lens", "count"), compact,
                       ref_compact):
        _equal(a, b, f"multi compact {f}")
    for f, a, b in zip(MAPS, _port_maps(st), ref_maps):
        _equal(a, b, f"multi {f}")
    assert st.step == 3 + K


# ---------------------------------------------------------------------------
# the mesh's own contracts (tests/test_parallel.py's, on the port)
# ---------------------------------------------------------------------------


def _run_steps(n_dp, n_mp, n_steps, bpd):
    step, st = _port_step(n_dp, n_mp, bpd=bpd)
    buf = torch.from_numpy(_seed_buf())
    statuses, rets = [], []
    for it in range(n_steps):
        st, s, r, *_ = step(st, buf, len(SEED), it)
        statuses.append(s.numpy())
        rets.append(r.numpy())
    return st, np.concatenate(statuses), np.concatenate(rets)


def test_mesh_shape_invariance_of_candidates():
    """The candidate stream depends on the global lane id, not the mesh
    shape: 8x1 and 4x2 meshes with the same global batch find the same
    crashes and end on the same maps."""
    s1, st1, _ = _run_steps(8, 1, 4, 16)
    s2, st2, _ = _run_steps(4, 2, 4, 32)
    assert (st1 == FUZZ_CRASH).sum() == (st2 == FUZZ_CRASH).sum() > 0
    for a, b in zip(_port_maps(s1), _port_maps(s2)):
        assert torch.equal(a, b)


def test_counter_folds_all_64_bits():
    """2**32 + 7 and 7 share a lo half but differ in hi: their mutant
    batches diverge (the JAX side of a counter past 2**32 is held in
    test_step_matches_jax)."""
    step, s0 = _port_step(4, 2, bpd=8)
    buf = torch.from_numpy(_seed_buf())
    low = step(s0, buf, len(SEED), 7)[6]
    assert torch.equal(low, step(s0, buf, len(SEED), np.int64(7))[6])
    assert not torch.equal(low, step(s0, buf, len(SEED), (1 << 32) + 7)[6])


def test_cross_dp_dedup_overreports_never_underreports():
    """In-batch dedup is per dp shard: the mesh may report MORE
    new-path lanes than one shard seeing the same global stream, never
    fewer, and the maps end identical."""
    news, finals = {}, {}
    for n_dp in (1, 4):
        st, _, rets = _run_steps(n_dp, 1, 4, 128 // n_dp)
        news[n_dp] = int((rets > 0).sum())
        finals[n_dp] = _port_maps(st)
    assert news[4] >= news[1] > 0
    for a, b in zip(finals[1], finals[4]):
        assert torch.equal(a, b)


def test_unique_crash_flags():
    """uc implies a crash; some crash is flagged unique; replaying the
    last step against the saturated maps flags none."""
    step, st = _port_step(4, 2, bpd=32)
    buf = torch.from_numpy(_seed_buf())
    total_uc = 0
    for it in range(6):
        st, statuses, _r, uc, *_ = step(st, buf, len(SEED), it)
        assert (~uc | (statuses == FUZZ_CRASH)).all()
        total_uc += int(uc.sum())
    assert total_uc >= 1
    assert int(step(st, buf, len(SEED), 5)[3].sum()) == 0


def test_superbatch_matches_sequential_steps():
    """step.multi is K sequential steps: packed verdicts, candidates
    and the final maps."""
    step, s = _port_step(4, 2, bpd=8)
    buf = torch.from_numpy(_seed_buf())
    seq = []
    for j in range(K):
        s, st, rets, uc, uh, _ec, bufs, lens, _c = step(s, buf, len(SEED),
                                                        j * 32)
        seq.append((pack_verdicts(st, rets, uc, uh), bufs, lens))
    s2 = sharded_state_init(_torch_mesh(4, 2), MAP_SIZE)
    s2, packed, mbufs, mlens, _c = step.multi(s2, buf, len(SEED), 0, K)
    for j in range(K):
        for a, b in zip(seq[j], (packed[j], mbufs[j], mlens[j])):
            assert torch.equal(a, b)
    for a, b in zip(_port_maps(s), _port_maps(s2)):
        assert torch.equal(a, b)


def test_sharded_triage_matches_single_device_reference():
    """The mp-sharded u-slot triage gives exactly the maps the port's
    single-device static_triage gives over the same candidate stream
    (the mesh's global-lane keys)."""
    prog = get_target("cgc_like")
    n_steps, n_dp = 4, 4
    step, st = _port_step(n_dp, 2)
    buf = torch.from_numpy(_seed_buf())
    for it in range(n_steps):
        st = step(st, buf, len(SEED), it)[0]
    u_slots, seg_id = (torch.from_numpy(a)
                       for a in make_static_maps(prog.edge_slot))
    instrs = torch.as_tensor(prog.instrs)
    table = torch.as_tensor(prog.edge_table)
    vb = vc = vh = torch.full((prog.map_size,), 0xFF, dtype=torch.uint8)
    lanes = torch.arange(BPD * n_dp, dtype=torch.int64)
    for it in range(n_steps):
        key = prng.fold_in(prng.fold_in(prng.key(0), it), 0)
        res, _b, _l = fuzz_batch_plain(
            instrs, table, *seed_ring(buf, len(SEED)), key, lanes,
            prog.mem_size, prog.max_steps, prog.n_edges)
        statuses = torch.where(res.status == 3, 1, res.status)
        _, _, _, vb, vc, vh = static_triage(
            vb, vc, vh, res.counts, u_slots, seg_id,
            statuses == FUZZ_CRASH, statuses == 1)
    for m, ref in zip(MAPS, (vb, vc, vh)):
        assert torch.equal(st.full_map(m), ref), m


def test_multimodule_program():
    """libtest's two 64KB slot spaces shard over mp like any map; both
    modules' slices see coverage."""
    step, st = _port_step(4, 2, target="libtest", max_len=8)
    buf = torch.from_numpy(_seed_buf(b"LXLX", 8))
    for it in range(4):
        st = step(st, buf, 4, it)[0]
    vb = st.full_map("virgin_bits")
    assert vb.shape == (2 * MAP_SIZE,)
    assert (vb[:MAP_SIZE] != 0xFF).sum() > 0
    assert (vb[MAP_SIZE:] != 0xFF).sum() > 0


# ---------------------------------------------------------------------------
# the CLI's --mesh campaign
# ---------------------------------------------------------------------------

N_CLI = 512     # 8 batches of 64: one K = 8 superbatch


def _findings(root):
    return {kind: sorted(f for f in os.listdir(os.path.join(root, kind))
                         if len(f) == 32)
            for kind in ("crashes", "hangs", "new_paths")}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs at --mesh 4,2 -b 64 -n 512 (default -fb), same seeds."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    seed = tmp / "seed"
    seed.write_bytes(SEED)
    out = {}
    for pkg, fn, extra in (("jax", jax_main, []),
                           ("torch", main, ["--device", "cpu"])):
        o = tmp / pkg
        rc = fn(["file", "jit_harness", "havoc", "--mesh", "4,2", "-i",
                 '{"target": "cgc_like", "novelty": "throughput"}', "-m",
                 '{"seed": 11}', "-sf", str(seed), "-o", str(o), "-b",
                 "64", "-n", str(N_CLI), "-isd", str(tmp / f"{pkg}.isd"),
                 *extra])
        assert rc == 0
        out[pkg] = o
    return tmp, out


def test_cli_mesh_campaign_matches_jax(cli_runs):
    """The product mesh path: findings md5-deduped on disk, the state
    dump, the stats counters and the mesh gauges equal the JAX CLI's."""
    tmp, out = cli_runs
    assert _findings(out["torch"]) == _findings(out["jax"])
    assert _findings(out["torch"])["new_paths"]
    assert _findings(out["torch"])["crashes"]
    got = json.loads((tmp / "torch.isd").read_text())
    assert got == json.loads((tmp / "jax.isd").read_text())
    assert got["total_execs"] == N_CLI and got["target"] == "cgc_like"
    stats = {p: parse_fuzzer_stats(str(out[p] / "fuzzer_stats"))
             for p in out}
    for k in ("execs_done", "paths_total", "unique_crashes",
              "unique_hangs"):
        assert stats["torch"][k] == stats["jax"][k], k
    assert int(stats["torch"]["execs_done"]) == N_CLI
    g = read_latest_snapshot(str(out["torch"]))["gauges"]
    ref = read_latest_snapshot(str(out["jax"]))["gauges"]
    for k in ("mesh_dp", "mesh_mp", "shard_step", "lanes_per_shard"):
        assert g[k] == ref[k], k
    assert g["mesh_dp"] == 4 and g["mesh_mp"] == 2 and g["shard_step"] == 8


def test_mesh_state_merges_like_jax(cli_runs):
    """The port's mesh state dump is a merger input: folded with a
    single-device JAX state by the JAX package's merger it gives the
    merged state the JAX campaign's dump gives."""
    tmp, _ = cli_runs
    single = jax_instr("jit_harness", '{"target": "cgc_like"}')
    single.enable(b"CGzzzzzz")
    (tmp / "single.json").write_text(single.get_state())
    merged = {p: merge_state_files(
        "jit_harness", '{"target": "cgc_like"}',
        [str(tmp / f"{p}.isd"), str(tmp / "single.json")])
        for p in ("torch", "jax")}
    assert merged["torch"] == merged["jax"]
    assert json.loads(merged["torch"])["total_execs"] == \
        N_CLI + single.total_execs


def test_cli_mesh_refusals(tmp_path, monkeypatch, capsys):
    """--mesh needs the card unless --device cpu is given, a batch that
    dp divides, and as many cards as shards."""
    seed = tmp_path / "seed"
    seed.write_bytes(SEED)
    argv = ["file", "jit_harness", "havoc", "-sf", str(seed), "-o",
            str(tmp_path / "o"), "-i", '{"target": "test"}', "-n", "64"]
    assert main(argv + ["--mesh", "3,1", "-b", "64",
                        "--device", "cpu"]) == 2
    assert "not divisible by dp=3" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv + ["--mesh", "2,1", "-b", "64"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
