"""The port's stateful session tier (``killerbeez_tpu_torch/stateful``,
``models/targets_stateful.py`` and the session surface of
``jit_harness``) against the JAX package's, on the CPU.  Each case
mirrors one of ``tests/test_stateful.py``; the JAX side runs on the
CPU as ``tests/conftest.py`` forces, the port on CPU tensors, and the
same numpy-made inputs must give identical bits:

  * the device framing parse (``parse_frames``) against JAX's and the
    host parses, on random buffers with too-short and zero-count rows;
  * ``run_session_batch`` against JAX's on 256 havoc mutants of each
    target's framed seed plus its crash sequences (all eight
    ``SessionResult`` fields), the host-driven reference against the
    in-scan executor, carried machine state, the deep-state
    certificate and single-shot unreachability;
  * both state triages against JAX's and the numpy witness, state
    novelty in the verdict, ``-G`` dispatches with the session tier,
    the stateful mesh step;
  * state export, merge and the layout guard (``set_state`` across
    packages), the admission signer's purity, and ``protocol`` and
    ``dictionary`` against JAX's.

Tolerance: none (bytes and integer counters)."""

import json

import numpy as np
import pytest
import torch

from killerbeez_tpu.instrumentation.factory import (
    instrumentation_factory as jax_instr,
)
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_stateful as jts
from killerbeez_tpu.mutators.factory import mutator_factory as jax_mut
from killerbeez_tpu.stateful import coverage as JC
from killerbeez_tpu.stateful import dictionary as JD
from killerbeez_tpu.stateful import framing as JF
from killerbeez_tpu.stateful import protocol as JP
from killerbeez_tpu.stateful import session as JS
from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_NONE
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.models import targets_stateful as ts
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.stateful import StatefulSpec
from killerbeez_tpu_torch.stateful import coverage as TC
from killerbeez_tpu_torch.stateful import dictionary as TD
from killerbeez_tpu_torch.stateful import framing as TF
from killerbeez_tpu_torch.stateful import protocol as TP
from killerbeez_tpu_torch.stateful import session as TS

torch.set_num_threads(1)

NAMES = ["session_auth", "tcp_like"]
#: each target's crash sequences (JAX tests/test_stateful.py:131)
CRASHES = {"session_auth": [[b"Lpw", b"QZ", b"QZ"], [b"QZ", b"QZ", b"QZ"]],
           "tcp_like": [[b"S\x10", b"A\x11", b"D\xf0!"],
                        [b"S\x10", b"A\x77", b"D\xf0!"]]}


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, what
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), what


def _session_inputs(name, n=256):
    """n havoc mutants of the framed seed (the port's havoc, held to the
    JAX mutator in test_torch_mutators.py) plus the crash sequences,
    as numpy rows."""
    seed = ts.framed_seed(name)
    mut = HavocMutator('{"seed": 5}', seed, device="cpu")
    bufs, lens = (_np(t) for t in mut.mutate_batch(n))
    spec = ts.get_stateful_spec(name)
    rows = [TF.frame_messages(m, spec.m_max) for m in CRASHES[name]]
    extra = np.zeros((len(rows), bufs.shape[1]), np.uint8)
    for i, r in enumerate(rows):
        extra[i, :len(r)] = np.frombuffer(r, np.uint8)
    return (np.concatenate([bufs, extra]),
            np.concatenate([lens, [len(r) for r in rows]]).astype(np.int32))


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_max", [1, 3, 4, 8])
def test_parse_frames_matches_jax(m_max):
    rng = np.random.default_rng(42 + m_max)
    B, L = 128, 40
    bufs = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    bufs[:8, 0] = 0                  # zero count: clips to one message
    lens[8:16] = rng.integers(0, 1 + m_max, size=8)   # shorter than
    lens[16] = 0                                      # the header
    got = TF.parse_frames(torch.as_tensor(bufs), torch.as_tensor(lens),
                          m_max)
    ref = JF.parse_frames(bufs, lens, m_max)
    host = TF.parse_frames_np(bufs, lens, m_max)
    for g, r, h, what in zip(got, ref, host, ("m", "offs", "mlens")):
        assert g.dtype == torch.int32
        _equal(g, r, what)
        _equal(g, h, what)
    for i in range(0, B, 7):
        msgs = TF.unframe(bytes(bufs[i, :lens[i]]), m_max)
        assert len(msgs) == int(got[0][i])
        assert [len(m) for m in msgs] == \
            [int(v) for v in got[2][i, :len(msgs)]]


def test_kb_frame_matches_jax(tmp_path):
    for mod, out in ((TF, tmp_path / "t.bin"), (JF, tmp_path / "j.bin")):
        assert mod.main(["-o", str(out), "-s", "Lpw", "-s", "Q",
                         "--m-max", "4"]) == 0
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert TF.unframe((tmp_path / "t.bin").read_bytes(), 4) == \
        [b"Lpw", b"Q"]


# ---------------------------------------------------------------------------
# the session executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_session_batch_matches_jax(name):
    bufs, lens = _session_inputs(name)
    spec = ts.get_stateful_spec(name)
    got = TS.run_session_batch(targets.get_target(name),
                               torch.as_tensor(bufs), torch.as_tensor(lens),
                               spec)
    ref = JS.run_session_batch(jax_targets.get_target(name), bufs, lens,
                               jts.get_stateful_spec(name))
    assert got._fields == ref._fields
    for f in got._fields:
        _equal(getattr(got, f), getattr(ref, f), f)
    status = _np(got.status)
    assert (status[-2:] == (FUZZ_CRASH, FUZZ_NONE)).all()
    assert (status == FUZZ_CRASH).any() and (_np(got.msgs) > 1).any()


@pytest.mark.parametrize("name", NAMES)
def test_host_reference_matches_in_scan(name):
    """The host-driven per-message reference == the in-scan executor,
    over random byte soup AND havoc mutants of the framed seed."""
    prog = targets.get_target(name)
    spec = ts.get_stateful_spec(name)
    rng = np.random.default_rng(7)
    soup = rng.integers(0, 256, size=(96, 48), dtype=np.uint8)
    soup_lens = rng.integers(0, 49, size=96).astype(np.int32)
    for bufs, lens in ((soup, soup_lens), _session_inputs(name, 64)):
        dev = TS.run_session_batch(prog, torch.as_tensor(bufs),
                                   torch.as_tensor(lens), spec)
        host = TS.host_reference_session_batch(prog, bufs, lens, spec,
                                               device="cpu")
        for f in dev._fields:
            _equal(getattr(dev, f), getattr(host, f), f)


def test_machine_state_carries_across_messages():
    """tcp_like's ACK cookie lives in scratch MEMORY written by the SYN
    handler: a correct ack works only because memory persists."""
    prog, jprog = targets.get_target("tcp_like"), \
        jax_targets.get_target("tcp_like")
    spec = ts.get_stateful_spec("tcp_like")
    for msgs, state in (([b"S\x30", b"A\x31"], 2),
                        ([b"S\x30", b"A\x30"], 0)):
        buf = TF.frame_messages(msgs, spec.m_max)
        res, pairs = TS.run_single_session(prog, buf, spec, device="cpu")
        jres, jpairs = JS.run_single_session(
            jprog, buf, jts.get_stateful_spec("tcp_like"))
        assert int(res.state_final[0]) == state
        assert pairs == jpairs
        for f in res._fields:
            _equal(getattr(res, f), getattr(jres, f), f)


@pytest.mark.parametrize("name", NAMES)
def test_deep_state_certificate(name):
    """The deep blocks and edges are the JAX package's; the solver
    refutes every deep edge with zero satisfiable paths, the seed
    SEQUENCE lights deep edges, and a session can light every deep
    block (the protocol fixpoint)."""
    from killerbeez_tpu_torch.analysis.solver import solve_edge, \
        unknown_kind
    prog = targets.get_target(name)
    jprog = jax_targets.get_target(name)
    deep = ts.deep_state_blocks(prog)
    assert deep and deep == jts.deep_state_blocks(jprog)
    assert ts.deep_state_edges(prog) == jts.deep_state_edges(jprog)
    ef, et = np.asarray(prog.edge_from), np.asarray(prog.edge_to)
    for e in ts.deep_state_edges(prog):
        r = solve_edge(prog, (int(ef[e]), int(et[e])))
        assert r.status in ("unsat", "unknown") and r.paths_tried == 0
        if r.status == "unknown":
            assert unknown_kind(r.reason) == "model"
    spec = ts.get_stateful_spec(name)
    res, _ = TS.run_single_session(prog, ts.framed_seed(name), spec,
                                   device="cpu")
    counts = res.counts[0, :-1]
    assert any(counts[e] for e in ts.deep_state_edges(prog))
    assert set(deep) <= TP.session_reachable_blocks(prog, spec)


def test_single_shot_cannot_reach_deep_slots(tmp_path):
    """The framed seed fuzzed STATELESSLY never lights a collision-free
    deep slot, and the port's virgin map is the JAX package's."""
    name = "session_auth"
    prog = targets.get_target(name)
    maps = {}
    for pkg in ("torch", "jax"):
        iopts = json.dumps({"target": name})
        if pkg == "torch":
            instr = JitHarnessInstrumentation(iopts, device="cpu")
            mut = HavocMutator('{"seed": 3}', ts.framed_seed(name),
                               device="cpu")
            drv = driver_factory("file", None, instr, mut, device="cpu")
            fz = Fuzzer(drv, output_dir=str(tmp_path / pkg),
                        batch_size=128, stats=False, feedback=0)
        else:
            from killerbeez_tpu.drivers.factory import driver_factory as jd
            from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
            instr = jax_instr("jit_harness", iopts)
            mut = jax_mut("havoc", '{"seed": 3}', ts.framed_seed(name))
            fz = JaxFuzzer(jd("file", None, instr, mut),
                           output_dir=str(tmp_path / pkg), batch_size=128,
                           telemetry=False, feedback=0)
        fz.run(1024)
        maps[pkg] = _np(instr.virgin_bits)
    _equal(maps["torch"], maps["jax"], "virgin_bits")
    slots = np.asarray(prog.edge_slot)
    deep = set(ts.deep_state_edges(prog))
    shallow = {int(slots[e]) for e in range(len(slots)) if e not in deep}
    deep_slots = {int(slots[e]) for e in deep} - shallow
    assert deep_slots and all(maps["torch"][s] == 0xFF for s in deep_slots)


# ---------------------------------------------------------------------------
# state x edge triage
# ---------------------------------------------------------------------------


def _se_cases():
    rng = np.random.default_rng(5)
    se = rng.integers(0, 4, size=(32, 4, 9), dtype=np.uint8)
    se[rng.random((32, 4, 9)) < 0.8] = 0
    se[20] = se[3]                    # an in-batch duplicate
    res = TS.run_session_batch(targets.get_target("tcp_like"),
                               *(torch.as_tensor(a) for a in
                                 _session_inputs("tcp_like", 512)),
                               ts.get_stateful_spec("tcp_like"))
    return [se, _np(res.se_counts)]


@pytest.mark.parametrize("case", [0, 1], ids=["random", "sessions"])
def test_state_triages_match_jax(case):
    se = _se_cases()[case]
    v0 = np.full(se.shape[1] * se.shape[2], 0xFF, np.uint8)
    v0[::7] = 0xF0                       # a partly touched map
    for tri, jtri in ((TC.state_triage_exact, JC.state_triage_exact),
                      (TC.state_triage, JC.state_triage)):
        rets, v = tri(torch.as_tensor(v0), torch.as_tensor(se))
        jrets, jv = jtri(v0, se)
        assert rets.dtype == torch.int32
        _equal(rets, jrets, tri.__name__)
        _equal(v, jv, tri.__name__)
    rets, v = TC.state_triage_exact(torch.as_tensor(v0),
                                    torch.as_tensor(se))
    nrets, nv = TC.np_state_triage_exact(v0, se)
    jnrets, jnv = JC.np_state_triage_exact(v0, se)
    for a, b in ((rets, nrets), (nrets, jnrets), (v, nv), (nv, jnv)):
        _equal(a, b, "numpy witness")
    assert (_np(rets) == 2).any()
    assert TC.state_coverage_stats(nv, se.shape[1]) == \
        JC.state_coverage_stats(nv, se.shape[1])
    assert TC.state_map_size(8, 30) == JC.state_map_size(8, 30) == 248


def test_state_novelty_joins_the_verdict():
    """A lane whose classic map is already known but whose state x edge
    pairs are new still reports novelty; the verdicts equal JAX's."""
    spec = ts.get_stateful_spec("session_auth")
    opts = json.dumps({"target": "session_auth", "stateful": 1})
    one = TF.frame_messages([b"QA"], spec.m_max)
    two = TF.frame_messages([b"Lpw", b"QA"], spec.m_max)
    verdicts = {}
    for pkg, instr in (("torch", JitHarnessInstrumentation(opts,
                                                           device="cpu")),
                       ("jax", jax_instr("jit_harness", opts))):
        out = []
        for buf in (one, one, two, two):
            arr = np.zeros((1, len(two) + 2), np.uint8)
            arr[0, :len(buf)] = np.frombuffer(buf, np.uint8)
            res = instr.run_batch(arr, np.array([len(buf)], np.int32))
            out.append(int(_np(res.new_paths)[0]))
        verdicts[pkg] = out
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"][1:] == [0, 2, 0] and verdicts["torch"][0] > 0


@pytest.mark.parametrize("reseed", [True, False])
@pytest.mark.parametrize("novelty", ["exact", "throughput"])
def test_generations_dispatch_matches_jax(novelty, reseed):
    """Two G = 4 dispatches of ``run_batch_generations`` with the
    session tier: every outcome field, the ring, and all four virgin
    maps."""
    opts = json.dumps({"target": "tcp_like", "stateful": 1,
                       "novelty": novelty})
    seed = ts.framed_seed("tcp_like")
    got = {}
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            instr = JitHarnessInstrumentation(opts, device="cpu")
            mut = HavocMutator('{"seed": 11}', seed, device="cpu")
        else:
            instr = jax_instr("jit_harness", opts)
            mut = jax_mut("havoc", '{"seed": 11}', seed)
        outs = []
        for _ in range(2):
            out = instr.run_batch_generations(mut, mut.peek_iterations(60),
                                              4, pad_to=64, reseed=reseed)
            mut.advance(4 * 60)
            outs.append(out.materialize())
        ring = instr._gen_ring
        got[pkg] = (outs, [_np(getattr(instr, m)) for m in
                           ("virgin_bits", "virgin_crash", "virgin_tmout",
                            "virgin_state")],
                    ring.view() if pkg == "torch" else ring)
    for (t, j) in zip(got["torch"][0], got["jax"][0]):
        for f in t._fields:
            _equal(getattr(t, f), getattr(j, f), f)
    for a, b in zip(got["torch"][1] + list(got["torch"][2]),
                    got["jax"][1] + list(got["jax"][2])):
        _equal(a, b, "virgin maps and ring")
    assert int(got["torch"][0][0].fr_ptr) > 0


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_matches_jax(shape):
    """Two stateful mesh steps and one two-step superbatch: verdicts,
    candidates, the compact report and all four maps."""
    from killerbeez_tpu.parallel import make_mesh as jax_mesh
    from killerbeez_tpu.parallel import make_sharded_fuzz_step as jax_step
    from killerbeez_tpu.parallel import sharded_state_init as jax_init
    from killerbeez_tpu_torch.parallel import (
        make_mesh, make_sharded_fuzz_step, sharded_state_init,
    )
    n_dp, n_mp = shape
    name = "tcp_like"
    spec = ts.get_stateful_spec(name)
    tup = (spec.m_max, spec.n_states, spec.state_reg)
    prog, jprog = targets.get_target(name), jax_targets.get_target(name)
    seed = np.frombuffer(ts.framed_seed(name), np.uint8).copy()
    smap = TC.state_map_size(spec.n_states, prog.n_edges)
    mesh = make_mesh(n_dp, n_mp, ["cpu"] * (n_dp * n_mp))
    step = make_sharded_fuzz_step(prog, mesh, 32, 32, seed=11,
                                  stateful=tup)
    jm = jax_mesh(n_dp, n_mp)
    jstep = jax_step(jprog, jm, 32, 32, seed=11, stateful=tup)
    st = sharded_state_init(mesh, prog.map_size, smap)
    jst = jax_init(jm, jprog.map_size, smap)
    b = 32 * n_dp
    for it in (0, b):
        st, *out = step(st, torch.as_tensor(seed), len(seed), it)
        jst, *jout = jstep(jst, seed, len(seed), it)
        for k, (a, r) in enumerate(zip(out[:7], jout[:7])):
            _equal(a, r, f"output {k}")
        for a, r in zip(out[7], jout[7]):
            _equal(a, r, "compact")
    st, *out = step.multi(st, torch.as_tensor(seed), len(seed), 2 * b, 2)
    jst, *jout = jstep.multi(jst, seed, len(seed), 2 * b, 2)
    for a, r in zip(out[:3], jout[:3]):
        _equal(a, r, "superbatch")
    for m in ("virgin_bits", "virgin_crash", "virgin_tmout"):
        _equal(st.full_map(m), getattr(jst, m), m)
    _equal(st.virgin_state, jst.virgin_state, "virgin_state")
    assert (_np(st.virgin_state) != 0xFF).any()


def test_stateful_mesh_needs_the_torch_engine():
    from killerbeez_tpu_torch.parallel import (
        make_mesh, make_sharded_fuzz_step, sharded_state_init,
    )
    prog = targets.get_target("tcp_like")
    mesh = make_mesh(1, 1, ["cpu"])
    with pytest.raises(ValueError, match="torch engine"):
        make_sharded_fuzz_step(prog, mesh, 8, 16, engine="cuda_fused",
                               stateful=(4, 8, 7))
    step = make_sharded_fuzz_step(prog, mesh, 8, 16, stateful=(4, 8, 7))
    with pytest.raises(ValueError, match="state_map_size"):
        step(sharded_state_init(mesh, prog.map_size),
             torch.zeros(8, dtype=torch.uint8), 8, 0)


# ---------------------------------------------------------------------------
# the instrumentation's session surface
# ---------------------------------------------------------------------------


def test_options_resolve_and_engines_stand_down(capsys):
    """The spec resolves as in the JAX package (explicit options, then
    the registered spec, then the defaults); a kernel engine stands
    down to the plain session executor with a warning; the fused path
    never runs sessions."""
    t = JitHarnessInstrumentation(json.dumps(
        {"target": "tcp_like", "stateful": 1, "msgs": 2}), device="cpu")
    j = jax_instr("jit_harness", json.dumps(
        {"target": "tcp_like", "stateful": 1, "msgs": 2}))
    assert t.stateful_spec == StatefulSpec(2, 8, 7)
    assert (j.stateful_spec.m_max, j.stateful_spec.n_states,
            j.stateful_spec.state_reg) == (2, 8, 7)
    t = JitHarnessInstrumentation(json.dumps(
        {"target": "test", "stateful": 1, "n_states": 4, "state_reg": 3,
         "engine": "cuda_fused"}), device="cpu")
    assert t.stateful_spec == StatefulSpec(4, 4, 3)
    assert t.engine == "torch" and "stands down" in capsys.readouterr().err
    mut = HavocMutator('{"seed": 1}', b"ABCD", device="cpu")
    assert not t.wants_fused(mut) and t.supports_generations(mut)


def test_state_export_merge_and_layout_guard():
    """get_state is the JAX package's string; set_state and merge take
    either package's state; a mismatched map size or spec is
    refused."""
    opts = json.dumps({"target": "tcp_like", "stateful": 1})
    buf = ts.framed_seed("tcp_like")
    a = JitHarnessInstrumentation(opts, device="cpu")
    ja = jax_instr("jit_harness", opts)
    a.enable(buf)
    ja.enable(buf)
    st, jst = a.get_state(), ja.get_state()
    assert st == jst and "virgin_state" in json.loads(st)
    for state in (st, jst):
        b = JitHarnessInstrumentation(opts, device="cpu")
        b.set_state(state)
        _equal(b.virgin_state, a.virgin_state, "set_state")
        c = JitHarnessInstrumentation(opts, device="cpu")
        c.merge(state)
        _equal(c.virgin_state, a.virgin_state, "merge")
    jb = jax_instr("jit_harness", opts)
    jb.set_state(st)
    assert jb.get_state() == st
    d = JitHarnessInstrumentation(json.dumps(
        {"target": "tcp_like", "stateful": 1, "n_states": 4}),
        device="cpu")
    with pytest.raises(ValueError, match="state-map is"):
        d.set_state(st)
    e = JitHarnessInstrumentation(json.dumps(
        {"target": "tcp_like", "stateful": 1, "state_reg": 6}),
        device="cpu")
    with pytest.raises(ValueError, match="state spec mismatch"):
        e.set_state(st)
    with pytest.raises(ValueError, match="state spec mismatch"):
        e.merge(st)


def test_state_signature_is_pure_and_matches_jax():
    opts = json.dumps({"target": "session_auth", "stateful": 1})
    instr = JitHarnessInstrumentation(opts, device="cpu")
    buf = ts.framed_seed("session_auth")
    instr.enable(buf)
    vb0, vs0 = instr.virgin_bits.clone(), instr.virgin_state.clone()
    pairs = instr.state_signature(buf)
    assert pairs == jax_instr("jit_harness", opts).state_signature(buf)
    assert len({s for s, _ in pairs}) >= 2
    assert torch.equal(instr.virgin_bits, vb0)
    assert torch.equal(instr.virgin_state, vs0)
    assert instr.state_coverage_stats() == \
        TC.state_coverage_stats(_np(vs0), 8)
    plain = JitHarnessInstrumentation('{"target": "test"}', device="cpu")
    assert plain.state_signature(b"x") is None
    assert plain.state_coverage_stats() is None


# ---------------------------------------------------------------------------
# protocol and dictionary (host modules, copied)
# ---------------------------------------------------------------------------


def _badproto(mod):
    a = mod.Assembler("badproto", mem_size=8, max_steps=64)
    a.block()
    a.ldi(1, 0)
    a.ldb(1, 1)
    a.ldi(2, ord("A"))
    a.br("eq", 1, 2, "adv")
    a.ldi(2, 5)
    a.br("eq", 7, 2, "deep")
    a.jmp("exit")
    a.label("adv")
    a.block()
    a.ldi(7, 12)
    a.halt(0)
    a.label("deep")
    a.block()
    a.halt(9)
    a.label("exit")
    a.block()
    a.halt(0)
    return a.build(block_seed=0xBAD)


@pytest.mark.parametrize("name", NAMES + ["badproto"])
def test_protocol_matches_jax(name):
    from killerbeez_tpu.models import compiler as jcomp
    from killerbeez_tpu.stateful import StatefulSpec as JSpec
    from killerbeez_tpu_torch.models import compiler as tcomp
    if name == "badproto":
        prog, jprog = _badproto(tcomp), _badproto(jcomp)
        spec, jspec = StatefulSpec(4, 8, 7), JSpec(4, 8, 7)
    else:
        prog, jprog = targets.get_target(name), \
            jax_targets.get_target(name)
        spec, jspec = ts.get_stateful_spec(name), \
            jts.get_stateful_spec(name)
    assert TP.reachable_states(prog, spec) == \
        JP.reachable_states(jprog, jspec)
    assert TP.unreachable_states(prog, spec) == \
        JP.unreachable_states(jprog, jspec)
    assert TP.declared_states(prog, spec) == \
        JP.declared_states(jprog, jspec)
    assert TP.state_assignments(prog, 7) == JP.state_assignments(jprog, 7)
    wp, jwp = (TP.with_initial_state(prog, 7, 1),
               JP.with_initial_state(jprog, 7, 1))
    _equal(wp.instrs, jwp.instrs, "with_initial_state")
    if name == "badproto":
        assert TP.unreachable_states(prog, spec) == [5]


@pytest.mark.parametrize("name", NAMES)
def test_dictionary_matches_jax(name):
    msgs = ts.seed_sequence(name)
    prog, spec = targets.get_target(name), ts.get_stateful_spec(name)
    groups = TD.extract_dictionary_groups(prog, spec, msgs, device="cpu")
    assert groups == JD.extract_dictionary_groups(
        jax_targets.get_target(name), jts.get_stateful_spec(name), msgs)
    assert TD.manager_options_for_target(name, device="cpu") == \
        JD.manager_options_for_target(name)
    if name == "session_auth":
        assert b"pw" in groups[0] and b"Z" not in groups[0]
        assert b"Z" in groups[1] and b"pw" not in groups[1]
