"""The learn tier in the port's campaigns against the JAX package's, on
the CPU: the counterparts of ``tests/test_learn.py``'s scan, campaign,
end-to-end and provenance cases.

  * version-0 weights: the shaped generation loops (one device, and the
    dp = 2 mesh) equal the JAX package's shaped scans and the port's
    unshaped loops, bit for bit, reseeding on and off;
  * trained weights carried across (``params_from_numpy``): one G = 4
    dispatch (the per-slot mask cache) equals four G = 1 dispatches
    (fresh inference every generation) and the JAX package's G = 4
    dispatch, bit for bit — after asserting that no logit of a slot the
    dispatch could select lies within 1e-4 of the mask threshold;
  * ``-G 4`` campaigns with a learn tier that never trains equal the
    JAX package's unshaped ones (findings and store), through the
    library and through both CLIs;
  * the loop end to end with an injected clock: labels, training,
    ``learn_update`` events, counters, provenance sidecars, and
    ``--resume`` in both packages;
  * provenance sidecars written by one package's store read by the
    other's ``provenance_positions``."""

import functools
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.corpus.store import CorpusStore as JaxStore
from killerbeez_tpu.drivers.factory import driver_factory as jax_driver
from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.instrumentation.factory import (
    instrumentation_factory as jax_instr,
)
from killerbeez_tpu.learn import LearnTier as JaxTier
from killerbeez_tpu.learn import dataset as jds
from killerbeez_tpu.learn import model as jm
from killerbeez_tpu.mutators.factory import mutator_factory as jax_mut
from killerbeez_tpu.parallel import ShardedCampaignDriver as JaxMesh
from killerbeez_tpu_torch.corpus.store import CorpusEntry, CorpusStore
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.learn import LearnTier, dataset, model
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.parallel import ShardedCampaignDriver

torch.set_num_threads(1)

SEED = b"ABCD1234"
MARGIN = 1e-4
MAPS = ("virgin_bits", "virgin_crash", "virgin_tmout")


@functools.lru_cache(maxsize=None)
def _jax_trained():
    """test_learn.py's ``_trained_params`` (60 JAX SGD steps), computed
    once per process."""
    rng = np.random.default_rng(5)
    params = jm.init_params()
    bufs = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    lens = np.full(64, 16, np.int32)
    positions = rng.integers(0, 16, 64).astype(np.int32)
    y = (positions < 4).astype(np.float32)
    X = jm.batch_features(bufs, lens, positions)
    w = np.where(y > 0, 4.0, 1.0).astype(np.float32)
    for _ in range(60):
        params, _ = jm.train_step(params, X, jnp.asarray(y),
                                  jnp.asarray(w), jnp.float32(0.5))
    return params


def _parts(pkg, iopts='{"target": "test"}'):
    if pkg == "jax":
        return jax_instr("jit_harness", iopts), \
            jax_mut("havoc", '{"seed": 7}', SEED)
    return JitHarnessInstrumentation(iopts, device="cpu"), \
        HavocMutator('{"seed": 7}', SEED, device="cpu")


def _gens(pkg, params, g, dispatches, reseed):
    """``dispatches`` generation dispatches of ``g`` on 64 lanes; returns
    (materialized outcomes, instrumentation)."""
    instr, mut = _parts(pkg)
    instr.learn_params = params
    outs = []
    for _ in range(dispatches):
        out = instr.run_batch_generations(mut, mut.peek_iterations(64), g,
                                          pad_to=64, reseed=reseed)
        outs.append(out.materialize())
        mut.advance(64 * g)
    return outs, instr


def _stored(h):
    st = min(int(h.fr_ptr), int(h.cap))
    return np.asarray(h.fr_bufs)[:st], np.asarray(h.fr_pack)[:st]


def _maps(instr):
    return [np.asarray(getattr(instr, m)) for m in MAPS]


@pytest.mark.parametrize("reseed", [False, True])
def test_generation_scan_learn_v0_parity_single_chip(reseed):
    (jh,), ji = _gens("jax", jm.init_params(), 4, 1, reseed)
    (mh,), mi = _gens("torch", model.init_params(), 4, 1, reseed)
    (uh,), ui = _gens("torch", None, 4, 1, reseed)
    assert int(jh.fr_ptr) == int(mh.fr_ptr) == int(uh.fr_ptr) > 0
    for a, b in ((jh, mh), (uh, mh)):
        for x, y in zip(_stored(a), _stored(b)):
            assert np.array_equal(x, y)
        assert np.array_equal(np.asarray(a.adm_bufs), np.asarray(b.adm_bufs))
        assert np.array_equal(np.asarray(a.sel), np.asarray(b.sel))
    for a, b, c in zip(_maps(ji), _maps(mi), _maps(ui)):
        assert np.array_equal(a, b) and np.array_equal(b, c)


def _slot_rows(h):
    """Every row a dispatch's generations could select: the seed and the
    ledger's admitted rows."""
    rows = [SEED]
    valid = np.asarray(h.adm_valid)
    for j, a in zip(*np.nonzero(valid)):
        rows.append(bytes(np.asarray(h.adm_bufs)[j, a,
                                                 :int(h.adm_len[j, a])]))
    return rows


@pytest.mark.parametrize("reseed", [False, True])
def test_mask_cache_matches_fresh_inference(reseed):
    jp = _jax_trained()
    mp = model.params_from_numpy([np.asarray(p) for p in jp])
    lg = model.saliency_logits(mp, torch.as_tensor(
        np.frombuffer(SEED, np.uint8).copy()), len(SEED))
    m = model.quantize_mask(lg, len(SEED))
    assert 0 < int(m[:len(SEED)].sum()) < len(SEED), \
        "trained mask neither all-ones nor all-zero"
    big, i_big = _gens("torch", mp, 4, 1, reseed)
    small, i_small = _gens("torch", mp, 1, 4, reseed)
    big_bufs = _stored(big[0])[0]
    small_bufs = np.concatenate([_stored(o)[0] for o in small])
    assert len(big_bufs), "nothing found — the comparison is vacuous"
    assert np.array_equal(big_bufs, small_bufs)
    for a, b in zip(_maps(i_big), _maps(i_small)):
        assert np.array_equal(a, b)
    # the JAX package's cached dispatch, once every selectable slot's
    # logits are held clear of the threshold
    (jh,), ji = _gens("jax", jp, 4, 1, reseed)
    for r in _slot_rows(jh):
        buf = np.zeros(len(SEED), np.uint8)
        buf[:len(r)] = np.frombuffer(r, np.uint8)[:len(SEED)]
        near = float(np.abs(np.asarray(jm.saliency_logits(
            jp, jnp.asarray(buf), jnp.int32(len(r)))))[:len(r)].min())
        assert near >= MARGIN, f"a slot logit lies {near} from 0"
    for x, y in zip(_stored(jh), _stored(big[0])):
        assert np.array_equal(x, y)
    for a, b in zip(_maps(ji), _maps(i_big)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("reseed", [False, True])
def test_mesh_generation_scan_learn_v0_parity(reseed):
    def run(pkg, params):
        instr, mut = _parts(pkg)
        drv = (JaxMesh if pkg == "jax" else ShardedCampaignDriver)(
            "2,1", instr, mut, batch_size=128)
        instr.learn_params = params
        return drv.test_batch_generations(128, 4, reseed=reseed
                                          ).materialize(), instr

    jh, ji = run("jax", jm.init_params())
    mh, mi = run("torch", model.init_params())
    uh, _ = run("torch", None)
    found = 0
    for d in range(2):
        a, b, c = jh.shard(d), mh.shard(d), uh.shard(d)
        assert int(a.fr_ptr) == int(b.fr_ptr) == int(c.fr_ptr)
        found += int(b.fr_ptr)
        for x, y, z in zip(_stored(a), _stored(b), _stored(c)):
            assert np.array_equal(x, y) and np.array_equal(y, z)
        assert np.array_equal(np.asarray(a.adm_bufs), np.asarray(b.adm_bufs))
    assert found > 0, "vacuous"
    assert np.array_equal(np.asarray(ji.virgin_bits),
                          np.asarray(mi.virgin_bits))


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------


def _findings(root):
    return {kind: sorted(f for f in os.listdir(os.path.join(root, kind))
                         if len(f) == 32)
            for kind in ("crashes", "hangs", "new_paths")}


def _entries(d):
    return sorted(f for f in os.listdir(d) if len(f) == 32)


@pytest.mark.parametrize("feedback", [0, 8])
def test_generation_campaign_learn_v0_parity(tmp_path, feedback):
    """-G 4 campaigns: the port with a learn tier that never trains
    against the JAX package without one, findings and store."""
    def run(pkg, name, learn):
        iopts = json.dumps({"target": "test", "learn": int(learn)})
        instr, mut = _parts(pkg, iopts)
        if pkg == "jax":
            drv = jax_driver("file", None, instr, mut)
            fz = JaxFuzzer(drv, output_dir=str(tmp_path / name),
                           batch_size=64, feedback=feedback, generations=4,
                           corpus_dir=str(tmp_path / name / "corpus"))
        else:
            drv = driver_factory("file", None, instr, mut, device="cpu")
            fz = Fuzzer(drv, output_dir=str(tmp_path / name),
                        batch_size=64, feedback=feedback, generations=4,
                        corpus_dir=str(tmp_path / name / "corpus"),
                        learn=(LearnTier(min_labels=10**9, device="cpu")
                               if learn else None))
        fz.run(1024)
        return fz

    run("jax", "off", False)
    fz = run("torch", "on", True)
    assert fz.learn.version == 0
    assert _findings(str(tmp_path / "on")) == _findings(str(tmp_path / "off"))
    assert _findings(str(tmp_path / "on"))["new_paths"], "vacuous"
    assert _entries(tmp_path / "on" / "corpus") == \
        _entries(tmp_path / "off" / "corpus")


@pytest.mark.parametrize("fb", ["0", "8"])
def test_cli_learn_campaign_matches_jax(tmp_path, fb):
    """Both CLIs at -G 4 --learn with training off (its interval past
    the clock): equal findings and instrumentation state."""
    (tmp_path / "seed").write_bytes(b"CG\x02\x04\x05Axxx")

    def argv(out):
        return ["file", "jit_harness", "havoc", "-sf",
                str(tmp_path / "seed"), "-i",
                '{"target": "cgc_like", "novelty": "throughput"}', "-m",
                '{"seed": 11}', "-b", "128", "-n", "2048", "-G", "4",
                "-fb", fb, "--learn", "--learn-interval", "1e12",
                "--no-stats", "-o", str(out), "-isd", f"{out}.isd"]

    assert main(argv(tmp_path / "t") + ["--device", "cpu"]) == 0
    assert jax_main(argv(tmp_path / "j")) == 0
    assert _findings(tmp_path / "t") == _findings(tmp_path / "j")
    assert _findings(tmp_path / "t")["new_paths"], "vacuous"
    assert (tmp_path / "t.isd").read_text() == \
        (tmp_path / "j.isd").read_text()


def test_cli_learn_refusals(tmp_path, capsys):
    (tmp_path / "seed").write_bytes(b"ABCD")
    base = ["file", "jit_harness", "havoc", "-sf", str(tmp_path / "seed"),
            "-i", '{"target": "test"}', "-o", str(tmp_path / "o"),
            "--device", "cpu", "--learn"]
    assert main(base + ["--crack"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    base[1] = "ipt"
    assert main(base) == 2
    assert "--learn needs the jit_harness" in capsys.readouterr().err


def _learn_campaign(tmp_path, name, resume=False, tier=None, clock=None,
                    pkg="torch"):
    iopts = '{"target": "cgc_like", "learn": 1}'
    seed = b"CG\x02\x04\x05Axxx"
    if pkg == "jax":
        instr = jax_instr("jit_harness", iopts)
        mut = jax_mut("havoc", '{"seed": 11}', seed)
        drv = jax_driver("file", None, instr, mut)
        return JaxFuzzer(drv, output_dir=str(tmp_path / name),
                         batch_size=256, feedback=8,
                         corpus_dir=str(tmp_path / name / "corpus"),
                         resume=resume, learn=tier)
    instr = JitHarnessInstrumentation(iopts, device="cpu")
    mut = HavocMutator('{"seed": 11}', seed, device="cpu")
    drv = driver_factory("file", None, instr, mut, device="cpu")
    tier = tier or LearnTier(train_interval_s=1.0, min_labels=8,
                             device="cpu", time_fn=clock or time.time)
    return Fuzzer(drv, output_dir=str(tmp_path / name), batch_size=256,
                  feedback=8, corpus_dir=str(tmp_path / name / "corpus"),
                  resume=resume, learn=tier)


def test_learn_e2e_trains_events_counters_resume(tmp_path):
    """The host-driven loop with an injected clock that advances a
    second per read: labels flow from admissions, rounds train between
    dispatches, learn_update events and the counters follow, sidecars
    carry provenance; --resume restores the model in both packages."""
    ticks = [0.0]

    def clock():
        ticks[0] += 1.0
        return ticks[0]

    fz = _learn_campaign(tmp_path, "c", clock=clock)
    fz.run(8192)
    tier = fz.learn
    assert len(tier.labels) > 0 and tier.labels.positives > 0
    assert tier.version > 0 and tier.train_steps > 0
    reg = fz.telemetry.registry
    assert reg.counters["learn_train_steps"] == tier.train_steps
    assert reg.gauges["learn_model_version"] == tier.version
    evs = [json.loads(line) for line in
           open(tmp_path / "c" / "events.jsonl") if line.strip()]
    ups = [e for e in evs if e["type"] == "learn_update"]
    assert ups and ups[-1]["version"] == tier.version
    provs = [e.provenance for e in CorpusStore(
        str(tmp_path / "c" / "corpus")).load() if e.provenance]
    assert provs
    fz2 = _learn_campaign(tmp_path, "c", resume=True,
                          tier=LearnTier(device="cpu"))
    assert fz2.learn.version == tier.version
    assert torch.equal(fz2.learn.params[4], tier.params[4])
    assert len(fz2.learn.labels) > 0
    fz3 = _learn_campaign(tmp_path, "c", resume=True, tier=JaxTier(),
                          pkg="jax")
    assert fz3.learn.version == tier.version
    assert np.array_equal(np.asarray(fz3.learn.params[4]),
                          tier.params[4].numpy())
    assert len(fz3.learn.labels) == len(fz2.learn.labels)


def test_learn_masks_shape_the_host_loop(tmp_path):
    """Once trained, rotations install the learned mask on the mutator
    (focus positions inside the seed) and the -G loop counts one mask per
    generation."""
    fz = _learn_campaign(tmp_path, "m")
    fz.learn.train_interval_s = 0.0
    fz.run(8192)
    assert fz.learn.version > 0
    mut = fz.driver.mutator
    assert fz.learn.masks_applied == \
        fz.telemetry.registry.counters.get("learn_masks_applied",
                                           fz.learn.masks_applied)
    if mut.focus_positions is not None:
        assert int(mut.focus_positions.max()) < mut.max_length


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_provenance_sidecar_across_packages(tmp_path, writer):
    parent, child = b"AAAAAAAA", b"ABAAAAAZ"
    prov = (dataset if writer == "torch" else jds).make_provenance(
        parent, child, "havoc", "havoc")
    if writer == "torch":
        CorpusStore(str(tmp_path)).put(CorpusEntry(child, parent="base",
                                                   provenance=prov))
        got = JaxStore(str(tmp_path)).load()
        positions = jds.provenance_positions
    else:
        from killerbeez_tpu.corpus.store import CorpusEntry as JaxEntry
        JaxStore(str(tmp_path)).put(JaxEntry(child, parent="base",
                                             provenance=prov))
        got = CorpusStore(str(tmp_path)).load()
        positions = dataset.provenance_positions
    (e,) = got
    assert e.provenance == prov
    assert positions(e.provenance, len(child)).tolist() == [1, 7]
