"""The port's learn tier (``killerbeez_tpu_torch/learn``) against the JAX
package's, on the CPU: the counterparts of ``tests/test_learn.py``'s
model and tier cases.

Tolerances: the features, the version-0 logits, the uniform bits of the
initial draw, the checkpoint encoding, labels and sample batches are
equal bit for bit.  ``init_params`` is within 1e-6 (``erfinv`` may
differ in the last ulps).  From the same weights (carried across with
``params_from_numpy``), logits are within 1e-5 and one SGD step's
parameters and loss within 1e-6 (float32 sums in another order); masks
are compared only after asserting that no logit lies within 1e-4 of the
threshold 0 — a test fails rather than skip when one does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.learn import LearnTier as JaxTier
from killerbeez_tpu.learn import model as jm
from killerbeez_tpu.ops import mutate_core as jmc
from killerbeez_tpu_torch.corpus.store import CorpusEntry
from killerbeez_tpu_torch.learn import LearnTier, dataset, model
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.ops import mutate_core as mc, prng
from killerbeez_tpu_torch.ops.vm_kernel import havoc_words_for_keys

torch.set_num_threads(1)

SEED = b"ABCD1234"
LOGIT_TOL = 1e-5
STEP_TOL = 1e-6
MARGIN = 1e-4


def _np(params):
    return [np.asarray(p) for p in params]


def _jax_trained():
    """test_learn.py's ``_trained_params``: 60 SGD steps on synthetic
    labels (early bytes useful), in the JAX package."""
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


def _assert_margin(logits, lens):
    """No live logit within MARGIN of the mask threshold (fails, never
    skips)."""
    for lg, n in zip(logits, lens):
        near = float(np.abs(np.asarray(lg)[:max(int(n), 1)]).min())
        assert near >= MARGIN, f"a logit lies {near} from 0 (margin " \
            f"{MARGIN}): masks cannot be compared"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [8, 24, 64])
def test_features_bit_for_bit(L):
    rng = np.random.default_rng(L)
    n = 200
    bufs = rng.integers(0, 256, (n, L), dtype=np.uint8)
    lens = rng.integers(0, L + 12, n).astype(np.int32)   # past L too
    poss = rng.integers(0, L, n).astype(np.int32)
    a = np.asarray(jm.batch_features(bufs, lens, poss))
    b = model.batch_features(torch.as_tensor(bufs), lens, poss).numpy()
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    one = model.feature_at(torch.as_tensor(bufs[3]), int(lens[3]),
                           int(poss[3])).numpy()
    ja = np.asarray(jm.feature_at(jnp.asarray(bufs[3]),
                                  jnp.int32(lens[3]), jnp.int32(poss[3])))
    assert np.array_equal(one.view(np.uint32), ja.view(np.uint32))


def test_v0_logits_exactly_zero_all_ones_mask():
    p = model.init_params()
    rng = np.random.default_rng(0)
    for ln in (1, 7, 16):
        buf = rng.integers(0, 256, 32).astype(np.uint8)
        lg = model.saliency_logits(p, torch.as_tensor(buf), ln)
        assert float(lg.abs().max()) == 0.0
        assert model.quantize_mask(lg, ln).tolist() == [1] * 32
        jl = np.asarray(jm.saliency_logits(jm.init_params(),
                                           jnp.asarray(buf), jnp.int32(ln)))
        assert np.array_equal(jl, lg.numpy())


def test_init_params_matches_jax():
    """The uniform bits under ``jax.random.normal`` exactly; the
    parameters within 1e-6; the zero layers exactly."""
    k1, _ = jax.random.split(jax.random.key(0x6b7a))
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    u = np.asarray(jax.random.uniform(k1, (11, 32), jnp.float32, lo, 1.0))
    tk = prng.split(prng.key(0x6b7a), 2)[0]
    f = prng.uniform(tk, 352)
    mine = torch.maximum(f * float(np.float32(1) - lo) + float(lo),
                         torch.full_like(f, float(lo)))
    assert np.array_equal(u.reshape(-1).view(np.uint32),
                          mine.numpy().view(np.uint32))
    for a, b in zip(_np(jm.init_params()), model.init_params()):
        assert a.shape == tuple(b.shape)
        assert np.abs(a - b.numpy()).max(initial=0.0) <= 1e-6
    for i in (1, 3, 4, 5):
        assert not model.init_params()[i].any()
    assert model.n_params(model.init_params()) == \
        jm.n_params(jm.init_params())


def test_encode_decode_across_packages():
    jp = _jax_trained()
    enc = jm.encode_params(jp)
    mine = model.decode_params(enc)
    for a, b in zip(_np(jp), mine):
        assert np.array_equal(a.view(np.uint32), b.numpy().view(np.uint32))
    back = jm.decode_params(model.encode_params(mine))
    for a, b in zip(_np(jp), _np(back)):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        model.decode_params({**enc, "w1": enc["w2"]})


def test_params_from_numpy_checks_shapes():
    p = model.params_from_numpy(_np(jm.init_params()))
    assert [tuple(t.shape) for t in p] == [(11, 32), (32,), (32, 16),
                                           (16,), (16,), ()]
    with pytest.raises(ValueError, match="shape"):
        model.params_from_numpy(_np(jm.init_params())[::-1])


def test_trained_logits_and_masks_match_jax():
    jp = _jax_trained()
    mine = model.params_from_numpy(_np(jp))
    rng = np.random.default_rng(9)
    bufs = [rng.integers(0, 256, 16).astype(np.uint8) for _ in range(8)]
    bufs.append(np.frombuffer(SEED + bytes(8), np.uint8).copy())
    lens = [16] * 8 + [len(SEED)]
    jl = [np.asarray(jm.saliency_logits(jp, jnp.asarray(b), jnp.int32(n)))
          for b, n in zip(bufs, lens)]
    ml = [model.saliency_logits(mine, torch.as_tensor(b), n).numpy()
          for b, n in zip(bufs, lens)]
    for a, b in zip(jl, ml):
        assert np.abs(a - b).max() <= LOGIT_TOL
    _assert_margin(jl, lens)
    for a, b, n in zip(jl, ml, lens):
        assert np.array_equal(
            np.asarray(jm.quantize_mask(jnp.asarray(a), jnp.int32(n))),
            model.quantize_mask(torch.as_tensor(b), n).numpy())
        assert np.array_equal(
            np.asarray(jm.masked_saliency(jp, jnp.asarray(bufs[0]),
                                          jnp.int32(16))),
            model.masked_saliency(mine, torch.as_tensor(bufs[0]),
                                  16).numpy())


@pytest.mark.parametrize("start", ["v0", "trained"])
def test_train_step_matches_jax(start):
    """One SGD step from the same weights on the same batch: the v0 start
    hits the max(logit, 0) tie at every sample (the gradient splits
    there in both packages)."""
    jp = jm.init_params() if start == "v0" else _jax_trained()
    rng = np.random.default_rng(3)
    bufs = rng.integers(0, 256, (128, 24), dtype=np.uint8)
    lens = rng.integers(1, 25, 128).astype(np.int32)
    poss = rng.integers(0, 24, 128).astype(np.int32)
    y = (rng.random(128) < 0.2).astype(np.float32)
    w = np.where(y > 0, 4.0, 1.0).astype(np.float32)
    jX = jm.batch_features(bufs, lens, poss)
    jnew, jloss = jm.train_step(jp, jX, jnp.asarray(y), jnp.asarray(w), 0.5)
    mX = model.batch_features(torch.as_tensor(bufs), lens, poss)
    mnew, mloss = model.train_step(model.params_from_numpy(_np(jp)), mX, y,
                                   w, 0.5)
    assert abs(float(jloss) - float(mloss)) <= STEP_TOL
    for a, b in zip(_np(jnew), mnew):
        assert np.abs(a - b.numpy()).max(initial=0.0) <= STEP_TOL
    assert not any(t.requires_grad for t in mnew)


def _admissions(n_parents=12, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_parents):
        parent = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
        for _ in range(3):
            child = bytearray(parent)
            for p in rng.choice(8, size=int(rng.integers(1, 4)),
                                replace=False):
                child[p] ^= int(rng.integers(1, 256))
            out.append((f"p{i}", parent, bytes(child)))
    return out


def test_train_round_matches_jax():
    """Two tiers fed the same admissions draw the same batches and end
    one round within tolerance."""
    jt = JaxTier(train_interval_s=0.0, min_labels=8, steps_per_round=4,
                 batch=64)
    mt = LearnTier(train_interval_s=0.0, min_labels=8, steps_per_round=4,
                   batch=64, device="cpu")
    for key, p, c in _admissions():
        assert jt.note_admission(key, p, c, "havoc") == \
            mt.note_admission(key, p, c, "havoc")
    jl, ml = jt.train_round(), mt.train_round()
    assert jt.version == mt.version == 1
    assert jt.train_steps == mt.train_steps == 4
    assert abs(jl - ml) <= 1e-5
    for a, b in zip(_np(jt.params), mt.params):
        assert np.abs(a - b.numpy()).max(initial=0.0) <= 1e-5


def test_tier_labels_batches_and_counters_match_jax():
    jt = JaxTier(min_labels=4)
    mt = LearnTier(min_labels=4, device="cpu")
    rng = np.random.default_rng(4)
    for key, p, c in _admissions(seed=4):
        jt.note_admission(key, p, c, "havoc", "havoc")
        mt.note_admission(key, p, c, "havoc", "havoc")
        rej = bytearray(p)
        rej[int(rng.integers(0, len(p)))] ^= 0x55
        jt.note_reject(key, p, bytes(rej))
        mt.note_reject(key, p, bytes(rej))
    for attr in ("positives", "total_added"):
        assert getattr(jt.labels, attr) == getattr(mt.labels, attr)
    assert len(jt.labels) == len(mt.labels)
    assert jt._reject_budget == mt._reject_budget
    for _ in range(3):
        for a, b in zip(jt.labels.make_batch(32), mt.labels.make_batch(32)):
            assert np.array_equal(a, b)
    assert jt.ready_to_train() == mt.ready_to_train()
    jt.maybe_train()
    mt.maybe_train()
    assert jt.version == mt.version and jt.train_steps == mt.train_steps
    sd_j, sd_m = jt.state_dict(), mt.state_dict()
    assert {k: v for k, v in sd_j.items() if k != "params"} == \
        {k: v for k, v in sd_m.items() if k != "params"}


def test_tier_checkpoint_restores_across_packages():
    jt = JaxTier(train_interval_s=0.0, min_labels=8)
    for key, p, c in _admissions():
        jt.note_admission(key, p, c, "havoc")
    jt.train_round()
    mt = LearnTier(device="cpu")
    mt.load_state(jt.state_dict())
    assert mt.version == jt.version and mt.train_steps == jt.train_steps
    for a, b in zip(_np(jt.params), mt.params):
        assert np.array_equal(a, b.numpy())
    back = JaxTier()
    back.load_state(mt.state_dict())
    for a, b in zip(_np(jt.params), _np(back.params)):
        assert np.array_equal(a, b)
    mt.load_state({"params": {"w1": "garbage"}, "version": 3})
    assert mt.version == 0     # a bad checkpoint restores a fresh model


def test_mask_for_and_focus_positions_match_jax():
    jt = JaxTier()
    mt = LearnTier(device="cpu")
    assert mt.mask_for(SEED) is None and mt.focus_positions_for(SEED) is None
    jp = _jax_trained()
    jt.params, jt.version = jp, 1
    mt.params, mt.version = model.params_from_numpy(_np(jp)), 1
    lg = np.asarray(jm.saliency_logits(
        jp, jnp.asarray(np.frombuffer(SEED, np.uint8)),
        jnp.int32(len(SEED))))
    _assert_margin([lg], [len(SEED)])
    assert np.array_equal(jt.mask_for(SEED), mt.mask_for(SEED))
    assert jt.focus_positions_for(SEED) == mt.focus_positions_for(SEED)
    assert jt.masks_applied == mt.masks_applied


# ---------------------------------------------------------------------------
# the masked havoc (the parity anchor), the tier's regressions
# ---------------------------------------------------------------------------


def test_masked_havoc_anchor_at_65536_lanes():
    """havoc_mask_at with an all-ones mask == havoc_at, byte for byte,
    at 65536 lanes; an all-zero mask falls back to uniform (== havoc_at
    too).  The lanes' words are seeded random bits (any bits are a valid
    draw; the key-to-words stream is held to JAX's in test_torch_prng)."""
    n, L = 65536, 24
    rng = np.random.default_rng(66)
    buf = torch.as_tensor(rng.integers(0, 256, L).astype(np.uint8))
    words = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 17 * 8),
                                         dtype=np.int32))
    a = mc.havoc_at(buf, 17, words)
    for mask in (torch.ones(L, dtype=torch.uint8),
                 torch.zeros(L, dtype=torch.uint8)):
        b = mc.havoc_mask_at(buf, 17, words, mask)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case_seed", [0, 7, 91])
def test_masked_havoc_matches_jax(case_seed):
    """A random mask, the JAX package's havoc_mask_at per key against the
    port's over the same keys."""
    rng = np.random.default_rng(case_seed)
    L = int(rng.choice([16, 24, 64]))
    ln = int(rng.integers(1, L + 1))
    buf = rng.integers(0, 256, L).astype(np.uint8)
    mask = (rng.random(L) < 0.4).astype(np.uint8)
    keys = [int(rng.integers(0, 2**31)) for _ in range(16)]
    for k in keys:
        jb, jl = jmc.havoc_mask_at(jnp.asarray(buf), jnp.int32(ln),
                                   jax.random.key(k), jnp.asarray(mask),
                                   stack_pow2=4)
        words = havoc_words_for_keys(prng.key(k)[None, :], 4)
        mb, ml = mc.havoc_mask_at(torch.as_tensor(buf), ln, words,
                                  torch.as_tensor(mask))
        assert np.array_equal(np.asarray(jb), mb[0].numpy())
        assert int(jl) == int(ml[0])


def test_model_learns_synthetic_positions():
    lb = dataset.LabelBuffer()
    rng = np.random.default_rng(1)
    for i in range(40):
        buf = rng.integers(0, 256, 24).astype(np.uint8).tobytes()
        lb.add(f"p{i}", buf, [0, 1, 2, 3], 1)
        lb.add(f"p{i}", buf, list(range(4, 24)), 0, cap=8)
    tier = LearnTier(train_interval_s=0.0, min_labels=10,
                     steps_per_round=50, device="cpu")
    tier.labels = lb
    loss = tier.train_round()
    assert tier.version == 1 and loss is not None and loss < 0.2
    unseen = bytes(rng.integers(0, 256, 24, dtype=np.uint8))
    pos = tier.focus_positions_for(unseen)
    assert pos is not None and sorted(set(pos)) == [0, 1, 2, 3]


def test_training_survives_label_buffer_saturation():
    tier = LearnTier(train_interval_s=0.0, min_labels=4, steps_per_round=1,
                     sample_cap=32, device="cpu")
    rng = np.random.default_rng(5)

    def feed(n):
        for _ in range(n):
            buf = rng.integers(0, 256, 16).astype(np.uint8).tobytes()
            tier.labels.add("k" + str(rng.integers(1 << 30)), buf, [0, 1], 1)
            tier.labels.add("k" + str(rng.integers(1 << 30)), buf, [4, 5], 0)

    feed(20)
    assert len(tier.labels) == 32
    assert tier.train_round() is not None
    v = tier.version
    feed(5)
    assert tier.ready_to_train()
    assert tier.maybe_train() and tier.version == v + 1
    assert not tier.ready_to_train()


def test_ready_to_train_reads_the_injected_clock():
    now = [100.0]
    tier = LearnTier(train_interval_s=5.0, min_labels=4, device="cpu",
                     time_fn=lambda: now[0])
    for key, p, c in _admissions(n_parents=4):
        tier.note_admission(key, p, c, "havoc")
    assert tier.ready_to_train()
    tier.train_round()
    now[0] += 1.0
    tier.note_admission(*_admissions(n_parents=1, seed=9)[0], "havoc")
    assert not tier.ready_to_train()       # inside the interval
    now[0] += 5.0
    assert tier.ready_to_train()


def test_resume_bootstrap_honors_informative_diff():
    parent = bytes(64)
    tier = LearnTier(device="cpu")
    tier.informative_diff = 4
    wide = bytearray(parent)
    for p in range(8):
        wide[p] ^= 0xFF
    prov = dataset.make_provenance(parent, bytes(wide), "havoc")
    entries = [CorpusEntry(bytes(wide), parent="base", provenance=prov)]
    assert tier.bootstrap(entries, lambda k: parent) == 0
    tier.informative_diff = 16
    assert tier.bootstrap(entries, lambda k: parent) == 1
    assert tier.labels.positives > 0


def test_informative_diff_rule():
    tier = LearnTier(device="cpu")
    parent = bytes(range(64))
    prov = tier.note_admission("p", parent, bytes(64), "havoc")
    assert prov is not None and prov["bytes"] == 63
    assert tier.labels.positives == 0
    small = bytearray(parent)
    small[5] ^= 0xFF
    tier.note_admission("p", parent, bytes(small), "havoc")
    assert tier.labels.positives == 1


def test_focus_mask_pad_pow2_shape_stability():
    mut = HavocMutator(None, SEED, device="cpu")
    mut.set_focus_mask([1, 3, 6], pad_pow2=True)
    got = mut.focus_positions.tolist()
    assert len(got) == 4 and set(got) == {1, 3, 6}
    mut.set_focus_mask(None)
    assert mut.focus_positions is None


def test_learned_mask_concentrates_on_live_offsets():
    from killerbeez_tpu_torch.models import targets_cgc
    seed = targets_cgc.fixedform_vm_seed()
    live = sorted({0, 1, 8, 16, 32, 64, 65, 72, 80} | set(range(24, 32)))
    tier = LearnTier(train_interval_s=0.0, min_labels=16,
                     steps_per_round=60, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(120):
        pos = rng.choice(live, size=2, replace=False)
        child = bytearray(seed)
        for p in pos:
            child[p] ^= int(rng.integers(1, 256))
        tier.note_admission("base", seed, bytes(child), "havoc")
    tier.train_round()
    mask = tier.mask_for(seed)
    kept = set(np.flatnonzero(mask[:len(seed)]).tolist())
    assert len(set(live) & kept) >= len(live) * 3 // 4
    assert len(kept) < len(seed) * 3 // 4


def test_learn_tier_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LearnTier()
