"""The port's grammar tier in campaigns, against the JAX package's, on
the CPU.  Each case mirrors one of ``tests/test_grammar.py``:

  * ``-G`` and ``--mesh 2,1`` with the degenerate grammar against the
    no-grammar run and JAX's; the structured ``-G`` campaign that
    cracks ``zoo:tlv:depth=2,bug=1`` at 2048 execs, held to JAX's; the
    structured mesh generations held to JAX's per shard;
  * the host-driven ``grammar`` mutator through both CLIs, its
    degenerate parity with havoc, and the rule that the ``cuda`` engine
    never fuses it (``cuda_fused`` does, with a warning);
  * the option rules: ``cuda_fused`` stands down to ``cuda`` with a
    grammar, the mesh takes ``torch`` or ``cuda``, grammar and learn
    are exclusive.

Tolerance: none (bytes and integer counters)."""

import json
import os

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
from killerbeez_tpu.parallel import ShardedCampaignDriver as JaxMesh
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.grammar.tables import degenerate_tables
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.models.zoo import build_zoo
from killerbeez_tpu_torch.mutators.grammar import GrammarMutator
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.parallel import ShardedCampaignDriver, make_mesh
from killerbeez_tpu_torch.parallel.distributed import _ShardKernels

torch.set_num_threads(1)

SEED = b"ABCD1234"


def _equal(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# generation loops: degenerate parity, structured campaigns
# ---------------------------------------------------------------------------


def _findings(out_dir):
    res = {}
    for kind in ("new_paths", "crashes", "hangs"):
        d = os.path.join(out_dir, kind)
        res[kind] = sorted(f for f in os.listdir(d) if len(f) == 32) \
            if os.path.isdir(d) else []
    return res


def _gen_campaign(pkg, out, iopts, seed, n, batch, corpus=True,
                  novelty=None):
    """A -G 4 campaign at -fb 0 of one package on the CPU; returns its
    instrumentation."""
    iopts = json.dumps(iopts)
    corpus_dir = str(out / "corpus") if corpus else None
    if pkg == "jax":
        instr = jax_instr("jit_harness", iopts)
        mut = jax_mut("havoc", '{"seed": 7}', seed)
        fz = JaxFuzzer(jax_driver("file", None, instr, mut),
                       output_dir=str(out), batch_size=batch, feedback=0,
                       generations=4, corpus_dir=corpus_dir)
    else:
        instr = JitHarnessInstrumentation(iopts, device="cpu")
        mut = HavocMutator('{"seed": 7}', seed, device="cpu")
        fz = Fuzzer(driver_factory("file", None, instr, mut, device="cpu"),
                    output_dir=str(out), batch_size=batch, feedback=0,
                    generations=4, corpus_dir=corpus_dir)
    fz.run(n)
    return instr, fz


def _entries(out):
    return sorted(f for f in os.listdir(out / "corpus") if len(f) == 32)


def test_generation_loop_degenerate_grammar_parity(tmp_path):
    """-G 4 with the degenerate grammar equals the port's no-grammar -G
    and JAX's degenerate-grammar -G: findings, store write-through and
    the virgin map."""
    runs = {}
    for pkg, grammar in (("torch", False), ("torch", True), ("jax", True)):
        iopts = {"target": "test"}
        if grammar:
            iopts["grammar"] = "degenerate"
        out = tmp_path / f"{pkg}_{grammar}"
        instr, _ = _gen_campaign(pkg, out, iopts, SEED, 1024, 64)
        runs[pkg, grammar] = (_findings(str(out)), _entries(out),
                              np.asarray(instr.virgin_bits))
    mine, base, ref = runs["torch", True], runs["torch", False], \
        runs["jax", True]
    assert mine[0]["new_paths"], "vacuous"
    for other in (base, ref):
        assert mine[0] == other[0] and mine[1] == other[1]
        _equal(mine[2], other[2], "virgin bits")


def _deep_hit(program, deep_edge, virgin_bits):
    slots = np.asarray(program.edge_slot)
    vb = np.asarray(virgin_bits)
    return any(int(vb[slots[e]]) != 0xFF
               for e in range(len(program.edge_to))
               if (int(program.edge_from[e]), int(program.edge_to[e]))
               == deep_edge)


def test_structured_campaign_cracks_certified_zoo_deep_edge(tmp_path):
    """The structured -G campaign reaches zoo:tlv:depth=2,bug=1's
    certified deep edge at 2048 execs, with JAX's findings and maps."""
    t = build_zoo("zoo:tlv:depth=2,bug=1")
    iopts = {"target": t.name, "novelty": "throughput",
             "grammar": t.grammar.to_json()}
    got = {}
    for pkg in ("torch", "jax"):
        out = tmp_path / pkg
        instr, fz = _gen_campaign(pkg, out, iopts, t.seed, 2048, 256,
                                  corpus=False)
        got[pkg] = (_findings(str(out)),
                    [np.asarray(getattr(instr, m)) for m in
                     ("virgin_bits", "virgin_crash", "virgin_tmout")],
                    fz.stats.crashes)
    assert got["torch"][0] == got["jax"][0]
    for a, b in zip(got["torch"][1], got["jax"][1]):
        _equal(a, b, "virgin maps")
    assert _deep_hit(t.program, t.deep_edge, got["torch"][1][0])
    assert got["torch"][2] > 0


def _mesh_generations(pkg, iopts, seed):
    iopts = json.dumps(iopts)
    if pkg == "jax":
        drv = JaxMesh("2,1", jax_instr("jit_harness", iopts),
                      jax_mut("havoc", '{"seed": 7}', seed), batch_size=128)
    else:
        drv = ShardedCampaignDriver(
            "2,1", JitHarnessInstrumentation(iopts, device="cpu"),
            HavocMutator('{"seed": 7}', seed, device="cpu"), batch_size=128)
    out = drv.test_batch_generations(128, 4).materialize()
    return out, drv.instrumentation


def _shard_rows(h):
    rows = []
    for d in range(2):
        s = h.shard(d)
        st = min(int(s.fr_ptr), int(s.cap))
        rows.append((int(s.fr_ptr), np.asarray(s.fr_bufs[:st]),
                     np.asarray(s.adm_bufs)))
    return rows


def test_mesh_generation_loop_degenerate_grammar_parity():
    """--mesh 2,1 generations with the degenerate tables equal the
    no-grammar mesh generations and JAX's, per shard."""
    got = {}
    for pkg, grammar in (("torch", False), ("torch", True), ("jax", True)):
        iopts = {"target": "test"}
        if grammar:
            iopts["grammar"] = "degenerate"
        h, instr = _mesh_generations(pkg, iopts, SEED)
        got[pkg, grammar] = (_shard_rows(h), np.asarray(
            instr.virgin_bits if pkg == "jax"
            else instr.virgin_bits.numpy()))
    mine = got["torch", True]
    assert sum(r[0] for r in mine[0]) > 0, "vacuous"
    for other in (got["torch", False], got["jax", True]):
        for a, b in zip(mine[0], other[0]):
            assert a[0] == b[0]
            _equal(a[1], b[1], "findings ring")
            _equal(a[2], b[2], "admissions")


def test_mesh_generation_loop_structured_grammar_matches_jax():
    """A non-degenerate grammar through --mesh 2,1 generations: the
    same per-shard findings rings and admissions as JAX's, and
    findings."""
    t = build_zoo("zoo:tlv:depth=2,bug=1")
    iopts = {"target": t.name, "grammar": t.grammar.to_json()}
    mine = _shard_rows(_mesh_generations("torch", iopts, t.seed)[0])
    ref = _shard_rows(_mesh_generations("jax", iopts, t.seed)[0])
    assert sum(r[0] for r in mine) > 0
    for a, b in zip(mine, ref):
        assert a[0] == b[0]
        _equal(a[1], b[1], "findings ring")
        _equal(a[2], b[2], "admissions")


# ---------------------------------------------------------------------------
# the host-driven grammar mutator, fusion and the option rules
# ---------------------------------------------------------------------------


def test_grammar_mutator_cli_matches_jax(tmp_path):
    """``file jit_harness grammar`` host-driven at -fb 0 through both
    CLIs on the zoo's tlv instance: the same findings and state."""
    t = build_zoo("zoo:tlv:depth=2,bug=1")
    seed = tmp_path / "seed"
    seed.write_bytes(t.seed)
    gfile = tmp_path / "grammar.json"
    gfile.write_text(t.grammar.to_json())
    got = {}
    for pkg, fn, extra in (("jax", jax_main, []),
                           ("torch", main, ["--device", "cpu"])):
        out = tmp_path / pkg
        rc = fn(["file", "jit_harness", "grammar", "-sf", str(seed),
                 "-i", json.dumps({"target": t.name,
                                   "novelty": "throughput"}),
                 "-m", json.dumps({"seed": 5, "grammar": f"@{gfile}",
                                   "grammar_stage": 200}),
                 "-o", str(out), "-b", "256", "-n", "1024", "-fb", "0",
                 "-isd", str(tmp_path / f"{pkg}.isd"), *extra])
        assert rc == 0
        got[pkg] = (_findings(str(out)),
                    (tmp_path / f"{pkg}.isd").read_text())
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["new_paths"]


def test_grammar_mutator_degenerate_equals_havoc():
    keys_its = np.arange(32, dtype=np.uint64)
    g = GrammarMutator('{"seed": 4}', SEED, device="cpu")
    h = HavocMutator('{"seed": 4}', SEED, device="cpu")
    a, al = g._generate(keys_its)
    b, bl = h._generate(keys_its)
    _equal(a, b)
    _equal(al, bl)


def test_cuda_engine_does_not_fuse_the_grammar_mutator(capsys):
    """The default cuda engine keeps the grammar mutator's structure
    (it mutates with grammar_havoc_at, unfused); an explicit
    cuda_fused fuses it as plain havoc, as the JAX package's
    pallas_fused does, and warns.  Havoc fuses under both."""
    instr = JitHarnessInstrumentation('{"target": "test"}', device="cpu")
    grammar = GrammarMutator('{"grammar": "auto", "target": "test"}', SEED,
                             device="cpu")
    havoc = HavocMutator(None, SEED, device="cpu")
    assert not instr.wants_fused(grammar)        # torch engine: never
    instr.engine = "cuda"
    assert not instr.wants_fused(grammar)
    assert instr.wants_fused(havoc)
    instr.engine = "cuda_fused"
    assert instr.wants_fused(grammar)
    assert instr.wants_fused(havoc)
    assert "structure stands down" in capsys.readouterr().err
    jax_h = jax_instr("jit_harness", '{"target": "test", '
                      '"engine": "pallas_fused"}')
    assert jax_h.wants_fused(jax_mut("grammar", None, SEED))


def test_grammar_stands_cuda_fused_down_to_cuda(monkeypatch, capsys):
    """With a grammar, an explicit cuda_fused stands down to cuda (the
    VM kernel over every lane), never to the plain torch engine."""
    # pretend a card is present: the engine is decided before any
    # tensor is placed on it; the first placement then fails here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises((AssertionError, RuntimeError)):
        JitHarnessInstrumentation(json.dumps(
            {"target": "test", "grammar": "degenerate",
             "engine": "cuda_fused"}), device="cuda")
    assert '"cuda_fused" stands down' in capsys.readouterr().err


def test_grammar_needs_torch_or_cuda_engine():
    prog = get_target("test")
    mesh = make_mesh(1, 1, ["cpu"])
    with pytest.raises(ValueError, match="torch or cuda engine"):
        _ShardKernels(prog, mesh, 8, 16, engine="cuda_fused",
                      grammar=degenerate_tables())
    _ShardKernels(prog, mesh, 8, 16, engine="cuda",
                  grammar=degenerate_tables())


def test_grammar_and_learn_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        JitHarnessInstrumentation(json.dumps(
            {"target": "test", "grammar": "degenerate", "learn": 1}),
            device="cpu")
