"""The port's trace surface against the JAX package's, bit for bit:
``jit_harness`` with ``{"edges": 1}`` (``get_edges``, ``last_trace``,
``get_edge_pairs``, the module API, the superbatch and ``-G`` standing
down), the ``ipt`` instrumentation unfiltered and filtered (CLI md5
sets and state strings, state loads and merges across packages), the
tracer and showmap tools' output files, ``static_edge_prior``, the
rare-edge scheduler primed with it, and ``--schedule rare-edge``
through both CLIs (md5 sets, the corpus sidecars' ``sig`` fields,
scheduler picks, state) host-driven at ``PIPELINE_DEPTH = 1`` and at
``-G 4`` (the ledger replay signs each admission).  Tolerance: none
(bytes, integers, and floats computed by the same operations)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from killerbeez_tpu.analysis import static_edge_prior as jax_prior
from killerbeez_tpu.corpus import schedule as jax_schedule
from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.instrumentation.factory import (
    instrumentation_factory as jax_instr,
)
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models.targets_cgc import tlvstack_vm_seed
from killerbeez_tpu.tools import showmap as jax_showmap
from killerbeez_tpu.tools import tracer as jax_tracer
from killerbeez_tpu_torch.analysis import static_edge_prior
from killerbeez_tpu_torch.corpus import schedule
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.factory import (
    instrumentation_factory,
)
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.tools import showmap, tracer

torch.set_num_threads(1)

# inputs starting with "L" run libtest's library module
LIBTEST_INPUTS = [b"A", b"LA", b"ABC@", b"ZZZZZZ", b"L", b"AB\x00", b"LLLL"]


def _inputs(name, n, seed):
    """``n`` single inputs: the target's seed with random edits."""
    from killerbeez_tpu.models.targets_cgc import VM_SEEDS
    rng = np.random.default_rng(seed)
    base = VM_SEEDS[name][0]() if name in VM_SEEDS else b"ABC@XY"
    out = [base]
    for _ in range(n - 1):
        b = bytearray(base)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        out.append(bytes(b[:rng.integers(1, len(b) + 1)]))
    return out


# -- jit_harness {"edges": 1} -----------------------------------------------

@pytest.mark.parametrize("name", ["libtest", "tlvstack_vm", "cgc_like"])
def test_edges_api_matches_jax(name):
    opts = json.dumps({"target": name, "edges": 1})
    ref = jax_instr("jit_harness", opts)
    got = instrumentation_factory("jit_harness", opts, device="cpu")
    assert got.get_edges() is None and got.last_trace() is None
    mods = got.get_module_info()
    assert mods == ref.get_module_info()
    assert got.module_map_ranges() == ref.module_map_ranges()
    ins = LIBTEST_INPUTS if name == "libtest" else _inputs(name, 6, 3)
    for data in ins:
        ref.enable(data)
        got.enable(data)
        assert got.get_fuzz_result() == ref.get_fuzz_result()
        assert got.is_new_path() == ref.is_new_path()
        assert got.get_edges() == ref.get_edges()
        np.testing.assert_array_equal(got.last_trace(), ref.last_trace())
        for module in [None] + mods:
            assert got.get_edge_pairs(module) == ref.get_edge_pairs(module)
        for module in mods:
            assert got.get_module_edges(module) == \
                ref.get_module_edges(module)
        assert got.module_coverage_bytes() == ref.module_coverage_bytes()
    assert got.get_state() == ref.get_state()
    if name == "libtest":
        assert len(mods) == 2 and got.get_module_edges(mods[1])


def test_edges_stands_down_the_superbatch_and_generations():
    """Edges mode keeps each batch's counts: the superbatch and the -G
    loop stand down, as in the JAX package."""
    for edges in (0, 1):
        instr = instrumentation_factory(
            "jit_harness", json.dumps({"target": "test", "edges": edges}),
            device="cpu")
        mut = HavocMutator('{"seed": 3}', b"ABC@", device="cpu")
        assert instr.supports_generations(mut) is not bool(edges)
        drv = driver_factory("file", None, instr, mut, device="cpu")
        assert drv.supports_batch_generations() is not bool(edges)
        out = drv.test_batch(64)
        assert (instr.get_edges() is None) is not bool(edges)
        if edges:
            # lane 0 of the batch: its counts, nothing else kept
            assert instr._last_counts.materialize().shape == \
                (1, instr.program.n_edges + 1)
        assert out.result.statuses.shape == (64,)


# -- ipt ---------------------------------------------------------------------

def _cli(pkg, out, instr, iopts, *extra, seed_file=None):
    """One package's CLI on the CPU; returns what the packages must
    agree on."""
    if seed_file is None:
        seed_file = out.parent / "seed.bin"
        seed_file.write_bytes(tlvstack_vm_seed())
    argv = ["file", instr, "havoc", "-sf", str(seed_file),
            "-m", '{"seed": 3}', "-b", "256", "-o", str(out),
            "-i", json.dumps(iopts), "-isd", f"{out}.isd", *extra]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxFuzzer, Fuzzer):
            mp.setattr(cls, "PIPELINE_DEPTH", 1)
        assert (jax_main if pkg == "jax" else main)(argv) == 0
    events = []
    if os.path.exists(out / "events.jsonl"):
        with open(out / "events.jsonl") as f:
            events = [json.loads(line) for line in f]
    return {
        "findings": {d: sorted(os.listdir(out / d))
                     for d in ("crashes", "hangs", "new_paths")},
        "isd": open(f"{out}.isd").read(),
        "picks": [(e["arm"], e["rotation"]) for e in events
                  if e["type"] == "scheduler_pick"],
    }


@pytest.mark.parametrize("filters", [None, [[0, 30000]],
                                     [[0, 12000], [40000, 65536]]])
def test_ipt_cli_matches_jax(filters, tmp_path):
    iopts = {"target": "tlvstack_vm"}
    if filters:
        iopts["filters"] = filters
    ref = _cli("jax", tmp_path / "jax", "ipt", iopts, "-n", "1536",
               "-fb", "0")
    got = _cli("torch", tmp_path / "torch", "ipt", iopts, "-n", "1536",
               "-fb", "0")
    assert got == ref
    assert got["findings"]["new_paths"]
    state = json.loads(got["isd"])
    assert state["hash_scheme"] == ("stream" if filters else "path+counts")
    assert len(state["hashes"]) == len(got["findings"]["new_paths"])


def test_ipt_state_loads_and_merges_across_packages():
    ins = _inputs("tlvstack_vm", 12, 5)
    states = {}
    for filters in (None, [[0, 30000]]):
        opts = {"target": "tlvstack_vm"}
        if filters:
            opts["filters"] = filters
        ref = jax_instr("ipt", json.dumps(opts))
        got = instrumentation_factory("ipt", json.dumps(opts),
                                      device="cpu")
        for data in ins[:8]:
            ref.enable(data)
            got.enable(data)
            assert (got.get_fuzz_result(), got.is_new_path(),
                    got.last_unique_crash(), got.last_unique_hang()) == \
                (ref.get_fuzz_result(), ref.is_new_path(),
                 ref.last_unique_crash(), ref.last_unique_hang())
        assert got.get_state() == ref.get_state()
        assert got.coverage_bytes() == ref.coverage_bytes()
        assert got.get_module_info() == ref.get_module_info()
        # a second pair of instances over other inputs, merged in
        ref2 = jax_instr("ipt", json.dumps(opts))
        got2 = instrumentation_factory("ipt", json.dumps(opts),
                                       device="cpu")
        for data in ins[6:]:
            ref2.enable(data)
            got2.enable(data)
        ref.merge(got2.get_state())
        got.merge(ref2.get_state())
        assert got.get_state() == ref.get_state()
        fresh = instrumentation_factory("ipt", json.dumps(opts),
                                        device="cpu")
        fresh.set_state(ref.get_state())
        assert fresh.get_state() == ref.get_state()
        states[bool(filters)] = (got, ref)
    # a foreign hash space is discarded, counters kept, in both
    got, ref = states[True]
    before = got.get_state()
    got.merge(states[False][0].get_state())
    ref.merge(states[False][1].get_state())
    assert got.get_state() == ref.get_state() == before


def test_ipt_qemu_mode_exits_2(tmp_path, capsys):
    argv = ["file", "ipt", "havoc", "-ss", "ABCD", "-o", str(tmp_path),
            "--device", "cpu", "-i", json.dumps({"qemu_mode": 1})]
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert "qemu_mode" in err and "not ported yet" in err


# -- tracer / showmap --------------------------------------------------------

@pytest.mark.parametrize("name", ["libtest", "tlvstack_vm"])
def test_tracer_and_showmap_outputs_match_jax(name, tmp_path):
    seed = tmp_path / "in.bin"
    seed.write_bytes(b"LXYZ" if name == "libtest" else tlvstack_vm_seed())
    iopts = json.dumps({"target": name})
    base = ["file", "jit_harness", "-sf", str(seed), "-i", iopts]
    for mod, pkg, dev in ((jax_tracer, "jax", []),
                          (tracer, "torch", ["--device", "cpu"])):
        assert mod.main(base + ["-n", "3", "-o",
                                str(tmp_path / f"{pkg}.slots")] + dev) == 0
        assert mod.main(base + ["-n", "2", "-f", "pairs", "-o",
                                str(tmp_path / f"{pkg}.pairs")] + dev) == 0
    for mod, pkg, dev in ((jax_showmap, "jax", []),
                          (showmap, "torch", ["--device", "cpu"])):
        assert mod.main(base + ["-o", str(tmp_path / f"{pkg}.map")]
                        + dev) == 0
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / "torch.*")))
    assert names == sorted(os.path.basename(p).replace("jax.", "torch.")
                           for p in glob.glob(str(tmp_path / "jax.*")))
    if name == "libtest":
        assert "torch.pairs.libtest1" in names
    for n in names:
        got = (tmp_path / n).read_bytes()
        assert got == (tmp_path / n.replace("torch.", "jax.")).read_bytes()
        assert got
    edges = jax_tracer.read_edge_file(str(tmp_path / "torch.slots"))
    prog = targets.get_target(name)
    assert showmap.static_summary(prog, edges) == \
        jax_showmap.static_summary(jax_targets.get_target(name), edges)


def test_tools_refuse_an_instrumentation_without_edges(tmp_path, capsys):
    seed = tmp_path / "in.bin"
    seed.write_bytes(b"ABCD")
    argv = ["file", "ipt", "-sf", str(seed), "--device", "cpu",
            "-i", json.dumps({"target": "test"})]
    assert tracer.main(argv + ["-o", str(tmp_path / "e")]) == 2
    assert "unknown option 'edges'" in capsys.readouterr().err
    assert tracer.force_edges_option('{"target": "x"}') == \
        jax_tracer.force_edges_option('{"target": "x"}')


# -- static edge prior and the rare-edge scheduler ---------------------------

@pytest.mark.parametrize("name", targets.target_names())
def test_static_edge_prior_matches_jax(name):
    assert static_edge_prior(targets.get_target(name)) == \
        jax_prior(jax_targets.get_target(name))


def _rare_edge_episode(mod, prior, seed):
    """A scripted episode of signed and unsigned admissions, finds,
    periods, drops and cap evictions through the rare-edge scheduler
    primed with ``prior``; every pick and the final edge counts."""
    import random
    rng = random.Random(seed)
    sch = mod.RareEdgeScheduler(cap=10)
    sch.set_static_prior(prior)
    sch.base_seed = b"BASE"
    slots = sorted(prior)
    picks, active = [], None
    for step in range(50):
        for _ in range(rng.randrange(3)):
            sig = rng.sample(slots, rng.randrange(0, 5))
            sch.admit(mod.Arm(bytes([step, rng.randrange(256)]),
                              sig=sig or None, parent="base",
                              discovered=float(step)))
        if sch.arms and rng.random() < 0.3:
            k = rng.randrange(len(sch.arms))
            sch.credit_find(sch.arms[k])
        sch.credit_period(active, 8)
        best, cand = sch.select()
        if best is not None and rng.random() < 0.1:
            sch.drop(best)
            best, cand = sch.select()
        active = None if best is None else sch.arms[best]
        picks.append((best, cand, sch.favored_count()))
    return picks, dict(sch.edge_hits), sch.state_dict()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rare_edge_scheduler_with_prior_matches_jax(seed):
    prior = static_edge_prior(targets.get_target("tlvstack_vm"))
    ref = _rare_edge_episode(jax_schedule, prior, seed)
    got = _rare_edge_episode(schedule, prior, seed)
    assert got == ref
    assert any(b is not None for b, _, _ in got[0])


# -- --schedule rare-edge through the CLI -----------------------------------

def _sigs(corpus_dir):
    out = {}
    for path in glob.glob(os.path.join(corpus_dir, "*.json")):
        with open(path) as f:
            meta = json.load(f)
        if "sig" in meta:
            out[os.path.basename(path)] = meta["sig"]
    return out


@pytest.mark.parametrize("extra", [("-n", str(40 * 256)),
                                   ("-n", str(16 * 256), "-G", "4")],
                         ids=["host", "generations"])
def test_rare_edge_cli_matches_jax(extra, tmp_path):
    """Host-driven at PIPELINE_DEPTH = 1 and at -G 4 (the ledger replay
    signs each admission): md5 sets, sidecar signatures, picks and
    instrumentation state equal the JAX CLI's."""
    got = {}
    for pkg in ("jax", "torch"):
        iopts = {"target": "tlvstack_vm", "novelty": "throughput",
                 "engine": "xla" if pkg == "jax" else "torch"}
        corpus = tmp_path / f"corpus_{pkg}"
        got[pkg] = _cli(pkg, tmp_path / pkg, "jit_harness", iopts,
                        *extra, "--schedule", "rare-edge",
                        "--corpus-dir", str(corpus))
        got[pkg]["sigs"] = _sigs(corpus)
    assert got["torch"] == got["jax"]
    sigs = got["torch"]["sigs"]
    assert sigs and all(sigs.values())
    assert len(sigs) <= len(got["torch"]["findings"]["new_paths"])
    if "-G" not in extra:
        assert any(arm != "base" for arm, _ in got["torch"]["picks"])
