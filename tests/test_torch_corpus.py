"""The port's corpus store and seed schedulers against the JAX
package's: every scheduler picks the same arm and the same candidate
bytes (splice included) at every rotation of one scripted episode of
admissions, finds, periods and drops, and ends in the same state; the
store's files are read back by either package; torn writes degrade,
never raise.  Tolerance: none (bytes, indices and float stats computed
by the same operations in the same order)."""

import json
import random

import pytest

from killerbeez_tpu.corpus import schedule as jax_schedule
from killerbeez_tpu.corpus import store as jax_store
from killerbeez_tpu_torch.corpus import schedule, store
from killerbeez_tpu_torch.resilience import chaos, checkpoint

SCHEDULERS = ["bandit", "rr"]


def _episode(mod, name, seed, steps=60):
    """Drive one package's scheduler through a scripted episode (the
    script comes from ``random.Random(seed)``, separate from the
    scheduler's own splice stream); returns every pick and the final
    state."""
    rng = random.Random(seed)
    sch = mod.make_scheduler(name, cap=12)
    sch.base_seed = b"SEED-" + bytes(range(20))
    picks = []
    active = None
    for step in range(steps):
        for _ in range(rng.randrange(3)):
            # shared prefix, differing middle and tail: splice has a
            # region to cross over in
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(4, 28)))
            sig = sorted(rng.sample(range(40), rng.randrange(0, 6)))
            sch.admit(mod.Arm(b"SEED-" + body, sig=sig or None,
                              parent="base", discovered=float(step)))
        for _ in range(rng.randrange(4)):
            # a find credits the GENERATING arm: any arm, or the base
            k = rng.randrange(len(sch.arms) + 1)
            sch.credit_find(sch.arms[k] if k < len(sch.arms) else None)
        sch.credit_period(active, 8)
        sch.rotations += 1
        best, cand = sch.select()
        if best is not None and len(cand) > 30:
            sch.drop(best)               # too wide for the buffer
            best, cand = sch.select()
        active = None if best is None else sch.arms[best]
        picks.append((best, cand, sch.favored_count()))
    stats = [(a.md5, a[1], a[2], a.seq) for a in sch.arms]
    return picks, stats, sch.state_dict(), sch


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_scheduler_episode_matches_jax(name, seed):
    ref = _episode(jax_schedule, name, seed)
    got = _episode(schedule, name, seed)
    assert got[:3] == ref[:3]
    assert any(best is not None for best, _, _ in got[0])
    if name == "bandit":
        # the splice ran: some candidates are no arm's own bytes
        arms_seen = {a[0] for a in ref[3].arms}
        assert any(best is not None and cand not in arms_seen
                   for best, cand, _ in got[0])


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("seed", [3, 4])
def test_scheduler_state_loads_across_packages(name, seed):
    """A scheduler restored from the other package's state (and its
    entries) keeps picking what the original picks."""
    *_, jax_sch = _episode(jax_schedule, name, seed)
    port = schedule.make_scheduler(name, cap=12)
    port.base_seed = jax_sch.base_seed
    port.load_entries([store.CorpusEntry.from_meta(
        a[0], a.to_entry().meta_dict()) for a in jax_sch.arms])
    port.load_state(json.loads(json.dumps(jax_sch.state_dict())))
    for a, b in zip(port.arms, jax_sch.arms):
        a[1], a[2] = b[1], b[2]
    for _ in range(10):
        assert port.select() == jax_sch.select()


def _entries(mod):
    e1 = mod.CorpusEntry(b"AAAA", seq=0, sig=[5, 9, 2], parent="base",
                         selections=1.5, finds=0.25, tier="cuda")
    e2 = mod.CorpusEntry(b"BBBBBB", seq=1, parent=e1.md5, source="sync")
    return e1, e2


@pytest.mark.parametrize("writer,reader", [(store, jax_store),
                                           (jax_store, store)])
def test_store_round_trip_across_packages(writer, reader, tmp_path):
    st = writer.CorpusStore(str(tmp_path))
    e1, e2 = _entries(writer)
    assert st.put(e1) and st.put(e2)
    assert not st.put(writer.CorpusEntry(b"AAAA"))     # md5 dedup
    st.save_checkpoint({"campaign": {"counters": {"execs": 42}},
                        "components": {"mutator": '{"iteration": 7}'}})
    back = reader.CorpusStore(str(tmp_path))
    loaded = back.load()
    assert [e.md5 for e in loaded] == [e1.md5, e2.md5]  # seq order
    assert [e.meta_dict() for e in loaded] == \
        [e1.meta_dict(), e2.meta_dict()]
    assert loaded[0].sig == [2, 5, 9] and loaded[0].tier == "cuda"
    assert loaded[0].cov_hash.startswith("sig:")
    assert loaded[1].cov_hash.startswith("md5:")
    assert back.load_state()["counters"]["execs"] == 42
    assert back.load_component_state("mutator") == '{"iteration": 7}'
    assert back.next_seq() == 2


def test_store_survives_torn_writes(tmp_path):
    """A stray temp file and a torn sidecar lose no entry (the bytes
    are the artifact); a chaos ``torn`` write leaves half a file at the
    final path, and every loader degrades instead of raising."""
    st = store.CorpusStore(str(tmp_path / "c"))
    e = store.CorpusEntry(b"DATA", seq=0, sig=[1])
    st.put(e)
    (tmp_path / "c" / "deadbeef.tmp").write_bytes(b"partial")
    (tmp_path / "c" / (e.md5 + ".json")).write_text('{"md5": trunc')
    loaded = st.load()
    assert [x.buf for x in loaded] == [b"DATA"] and loaded[0].sig is None

    torn = store.CorpusStore(str(tmp_path / "t"))
    torn.save_state({"version": 1, "counters": {"execs": 1}})
    chaos.configure({"faults": [
        {"point": "persist", "mode": "torn", "hit": 1}]})
    try:
        torn.save_state({"version": 1, "counters": {"execs": 2}})
    finally:
        chaos.configure(None)
    with pytest.raises(ValueError):
        json.loads((tmp_path / "t" / "campaign.json").read_text())
    assert torn.load_state() is None and torn.load() == []


def test_checkpoint_torn_live_file_heals_from_prev(tmp_path):
    root = str(tmp_path)
    checkpoint.save(root, {"campaign": {"execs": 1}})
    checkpoint.save(root, {"campaign": {"execs": 2}})
    (tmp_path / checkpoint.CHECKPOINT_FILE).write_text(
        '{"epoch": 3, "campaign": {"ex')
    doc = checkpoint.load(root)
    assert doc["epoch"] == 1 and doc["campaign"]["execs"] == 1
    assert checkpoint.save(root, {"campaign": {"execs": 3}}) == 2
