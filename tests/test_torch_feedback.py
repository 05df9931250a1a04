"""Corpus feedback in the port against the JAX package: the CLI's
default campaign (no ``-fb`` flag: a seed rotation every 8 batches)
on ``tlvstack_vm`` with ``-m '{"seed": 3}' -b 512`` writes the same
md5 sets, dumps the same ``-isd``/``-msd`` state strings, picks the
same arms in the same rotations (``scheduler_pick`` events) and counts
the same ``fuzzer_stats`` totals, under ``--schedule bandit`` and
``rr`` and with exact novelty; and a ``--corpus-dir`` campaign of
either package resumes under the other exactly as under its own.
Tolerance: none (bytes and integer counters).

Rotation reads only the findings triage has already landed, so at the
default pipeline depth neither package repeats a campaign exactly from
run to run.  These tests set ``PIPELINE_DEPTH = 1`` on both packages'
``Fuzzer``: every batch is triaged before the next rotation boundary,
so the rotation decisions are fixed.  At the default depth the
packages agree when neither drains a landed batch at a boundary
(``test_credit_across_the_pipeline_matches_jax``: finds credit the arm
that generated them), and the mechanism is pinned
(``test_rotation_mechanism_at_default_depth``)."""

import json
import os
import shutil

import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.models.targets_cgc import tlvstack_vm_seed
from killerbeez_tpu_torch.corpus.store import CorpusStore
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

COUNTERS = ("execs_done", "paths_total", "unique_crashes", "unique_hangs")


def _campaign(pkg, seed, out, novelty, *extra, batch=512, landed=True):
    """Run one package's CLI with PIPELINE_DEPTH = 1 on both Fuzzer
    classes — or, with ``landed=False``, at the default depth with no
    batch's results landed at any rotation boundary (``_drain_ready``
    a no-op in both); returns what the two packages must agree on."""
    iopts = {"target": "tlvstack_vm", "novelty": novelty,
             "engine": "xla" if pkg == "jax" else "torch"}
    argv = ["file", "jit_harness", "havoc", "-sf", str(seed),
            "-m", '{"seed": 3}', "-b", str(batch), "-o", str(out),
            "-i", json.dumps(iopts), "-isd", f"{out}.isd",
            "-msd", f"{out}.msd", *extra]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxFuzzer, Fuzzer):
            if landed:
                mp.setattr(cls, "PIPELINE_DEPTH", 1)
            else:
                mp.setattr(cls, "_drain_ready", lambda self, pending: None)
        assert (jax_main if pkg == "jax" else main)(argv) == 0
    return _summary(out)


def _summary(out):
    stats = {}
    with open(os.path.join(out, "fuzzer_stats")) as f:
        for line in f:
            k, v = line.split(":", 1)
            stats[k.strip()] = v.strip()
    with open(os.path.join(out, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return {
        "findings": {d: sorted(os.listdir(os.path.join(out, d)))
                     for d in ("crashes", "hangs", "new_paths")},
        "isd": open(f"{out}.isd").read(),
        "msd": open(f"{out}.msd").read(),
        "picks": [(e["arm"], e["rotation"]) for e in events
                  if e["type"] == "scheduler_pick"],
        "new_path_events": sum(e["type"] == "new_path" for e in events),
        "counters": {k: stats[k] for k in COUNTERS},
    }


def _arms(corpus_dir):
    """The arms and scheduler state of a corpus store's checkpoint, and
    each stored entry's lineage parent."""
    st = CorpusStore(str(corpus_dir))
    camp = st.load_state()
    counters = {k: v for k, v in camp["counters"].items()
                if not k.endswith("_seconds")}      # wall times
    return {"arm_stats": camp["arm_stats"], "counters": counters,
            "scheduler_state": camp["scheduler_state"],
            "fb_batches": camp["fb_batches"],
            "parents": {e.md5: e.parent for e in st.load()}}


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    path = tmp_path_factory.mktemp("feedback") / "seed.bin"
    path.write_bytes(tlvstack_vm_seed())
    return path


# -n is the first whole batch after the first rotation that lands on
# an admitted arm rather than the base seed: rotation 3 (after 24
# batches) for bandit with exact novelty, rotation 4 (32 batches) with
# throughput novelty, and rotation 2 (16 batches) for rr
@pytest.mark.parametrize("schedule,novelty,n", [
    ("bandit", "throughput", 33 * 512),
    ("rr", "throughput", 17 * 512),
    ("bandit", "exact", 25 * 512),
])
def test_default_feedback_matches_jax(schedule, novelty, n, seed,
                                      tmp_path):
    extra = ("-n", str(n), "--schedule", schedule)
    ref = _campaign("jax", seed, tmp_path / "jax", novelty, *extra)
    got = _campaign("torch", seed, tmp_path / "torch", novelty, *extra)
    assert got == ref
    assert got["counters"]["execs_done"] == str(n)
    assert got["findings"]["new_paths"]
    assert any(arm != "base" for arm, _ in got["picks"]), got["picks"]
    assert got["new_path_events"] == int(got["counters"]["paths_total"])


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_resume_across_packages(first, seed, tmp_path):
    """A ``--corpus-dir`` campaign of one package, then ``--resume`` of
    a copy under each package: equal findings, state, counters, rotation
    picks and arms."""
    base = tmp_path / "base"
    _campaign(first, seed, base, "throughput", "-n", str(16 * 512),
              "--corpus-dir", str(base / "corpus"))
    assert _arms(base / "corpus")["arm_stats"]
    got = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / f"resumed_{pkg}"
        shutil.copytree(base, out)
        got[pkg] = _campaign(pkg, seed, out, "throughput", "-n",
                             str(9 * 512), "--resume")
        got[pkg]["arms"] = _arms(out / "corpus")
    assert got["torch"] == got["jax"]
    assert got["torch"]["counters"]["execs_done"] == str(25 * 512)
    assert got["torch"]["arms"]["counters"]["execs"] == 25 * 512


def test_credit_across_the_pipeline_matches_jax(seed, tmp_path):
    """At the default depth, with no batch landed at any rotation
    boundary (the slowest host), triage runs up to 24 batches behind
    generation and across rotations: each find must credit, and name as
    its parent, the arm that GENERATED its batch, as in the JAX loop.
    rr rotates onto a new arm every 16 batches of 128 lanes."""
    extra = ("-n", str(96 * 128), "--schedule", "rr")
    got = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        got[pkg] = _campaign(pkg, seed, out, "throughput", *extra,
                             "--corpus-dir", str(out / "corpus"),
                             batch=128, landed=False)
        got[pkg]["arms"] = _arms(out / "corpus")
    assert got["torch"] == got["jax"]
    arms = got["torch"]["arms"]
    assert any(p != "base" for p in arms["parents"].values())
    assert any(finds > 0 for _, finds in arms["arm_stats"].values())


def test_rotation_mechanism_at_default_depth(tmp_path):
    """At the default PIPELINE_DEPTH the port rotates without draining
    the pipeline: arms are admitted from edge-novel findings only, the
    walk stays monotonic, the seed swaps keep the candidate width, and
    the base seed anchors the rotation."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    s = tlvstack_vm_seed()
    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "novelty": "throughput"}',
        device="cpu")
    mut = HavocMutator('{"seed": 2}', s, device="cpu")
    width = mut.max_length
    drv = driver_factory("file", None, instr, mut, device="cpu")
    fz = Fuzzer(drv, output_dir=str(tmp_path), batch_size=256,
                feedback=2)
    assert fz.PIPELINE_DEPTH == 24
    stats = fz.run(4096)
    assert stats.new_paths > 0
    assert fz.scheduler.arms and fz.scheduler.rotations > 0
    assert all(len(a) == 3 and a[1] >= 0 and a[2] >= 0
               for a in fz.scheduler.arms)
    assert fz.scheduler.base_stats[0] > 0
    assert fz.scheduler.base_seed == s
    assert mut.max_length == width == len(mut.seed_buf)
    assert mut.get_current_iteration() == 4096
    assert len(os.listdir(tmp_path / "new_paths")) == \
        len(fz._seen["new_paths"]) > 0
