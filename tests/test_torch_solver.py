"""The port's copied analysis tier against the JAX package's, on every
built-in target: ``solve_edge`` and ``solve_edge_vsa`` verdicts (a
spread of each target's static edges), ``analyze_vsa`` documents,
``value_priors``, ``lint_program`` with and without value sets,
``edge_dep_mask``, ``concrete_run`` and ``check_replay``; the crack
stage's store sidecars (solver cache, VSA document) byte for byte in
both directions; and the ``kb-solve`` / ``kb-lint`` tools' output
(``kb-lint --gaps-dir`` on an empty directory too).  Tolerance: none."""

import contextlib
import io
import json

import numpy as np
import pytest

from killerbeez_tpu import analysis as JA
from killerbeez_tpu.corpus.store import CorpusStore as JaxStore
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_cgc as jax_cgc
from killerbeez_tpu.tools import lint_tool as jax_lint
from killerbeez_tpu.tools import solve_tool as jax_solve
from killerbeez_tpu_torch import analysis as TA
from killerbeez_tpu_torch.corpus.store import CorpusStore
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.tools import lint_tool, solve_tool

NAMES = sorted(targets.target_names())


def _progs(name):
    return jax_targets.get_target(name), targets.get_target(name)


def _edges(prog, cap):
    """Up to ``cap`` static edges spread over the universe."""
    edges = [(int(f), int(t)) for f, t in zip(prog.edge_from,
                                              prog.edge_to)]
    step = max(1, len(edges) // cap)
    return edges[::step][:cap]


@pytest.mark.parametrize("name", NAMES)
def test_solver_verdicts_match_jax(name):
    jp, tp = _progs(name)
    for e in _edges(tp, 16):
        assert TA.solve_edge(tp, e).as_dict() == \
            JA.solve_edge(jp, e).as_dict(), e


@pytest.mark.parametrize("name", NAMES)
def test_vsa_and_vsa_solver_match_jax(name):
    """The value-set fixpoint document, the seeded solver on a few
    edges (their ``vsa`` metadata included), and the seed domains."""
    jp, tp = _progs(name)
    jv, tv = JA.analyze_vsa(jp), TA.analyze_vsa(tp)
    assert json.dumps(tv.to_doc(), sort_keys=True) == \
        json.dumps(jv.to_doc(), sort_keys=True)
    assert TA.vsa_stats(tv) == JA.vsa_stats(jv)
    for e in _edges(tp, 4):
        assert TA.solve_edge_vsa(tp, e, vsa=tv).as_dict() == \
            JA.solve_edge_vsa(jp, e, vsa=jv).as_dict(), e
        assert repr(TA.vsa_seed_domains(tp, tv, e)) == \
            repr(JA.vsa_seed_domains(jp, jv, e))
    # a cached document rehydrates against the port's program
    back = TA.VsaResult.from_doc(jv.to_doc(), tp)
    assert back is not None
    assert back.to_doc() == tv.to_doc()


@pytest.mark.parametrize("name", NAMES)
def test_priors_and_lint_match_jax(name):
    jp, tp = _progs(name)
    jv, tv = JA.analyze_vsa(jp), TA.analyze_vsa(tp)
    assert TA.value_priors(tp, tv, target=name) == \
        JA.value_priors(jp, jv, target=name)
    for vsa in (None, (jv, tv)):
        ref = JA.lint_program(jp, vsa=vsa and vsa[0])
        out = TA.lint_program(tp, vsa=vsa and vsa[1])
        assert [f.as_dict() for f in out] == [f.as_dict() for f in ref]
    edges = _edges(tp, 6)
    assert TA.edge_dep_mask(tp, edges) == JA.edge_dep_mask(jp, edges)


@pytest.mark.parametrize("name", NAMES)
def test_concrete_run_and_replay_match_jax(name):
    jp, tp = _progs(name)
    fn = jax_cgc.VM_SEEDS.get(name)
    rng = np.random.default_rng(3)
    inputs = [b"", b"ABCD", b"CG\x02\x04\xff\x01"] + \
        [rng.integers(0, 256, 12).astype(np.uint8).tobytes()
         for _ in range(4)] + ([fn[0]()] if fn else [])
    jv, tv = JA.analyze_vsa(jp), TA.analyze_vsa(tp)
    for data in inputs:
        r, o = JA.concrete_run(jp, data), TA.concrete_run(tp, data)
        assert (o.status, o.steps, o.edges, o.blocks) == \
            (r.status, r.steps, r.edges, r.blocks)
        assert TA.check_replay(tp, data, tv) == \
            JA.check_replay(jp, data, jv)


def test_priors_sidecar_round_trips_across_packages(tmp_path):
    jp, tp = _progs("imgparse_vm")
    doc = TA.value_priors(tp, target="imgparse_vm")
    TA.save_priors(tmp_path / "p.json", doc)
    JA.save_priors(tmp_path / "j.json",
                   JA.value_priors(jp, target="imgparse_vm"))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert JA.load_priors(tmp_path / "p.json", jp) == doc
    assert TA.load_priors(tmp_path / "j.json", tp) == doc


@pytest.mark.parametrize("with_checkpoint", [False, True],
                         ids=["standalone", "checkpoint"])
def test_crack_sidecars_are_byte_equal(tmp_path, with_checkpoint):
    """save_solver_cache / save_vsa_doc write the same files and the
    same checkpoint epoch in both packages, and each package loads the
    other's."""
    cache = {"4:5": {"status": "solved", "reason": "",
                     "input_hex": "41424344"},
             "2:3": {"status": "unknown", "reason": "budget",
                     "search": {"status": "exhausted", "steps": 4}}}
    doc = TA.analyze_vsa(targets.get_target("cgc_like")).to_doc()
    roots = {}
    for tag, cls in (("jax", JaxStore), ("torch", CorpusStore)):
        st = cls(str(tmp_path / tag))
        if with_checkpoint:
            st.save_checkpoint({"campaign": {"version": 1}})
        st.save_solver_cache(cache)
        st.save_vsa_doc(doc)
        roots[tag] = tmp_path / tag
    for f in ("solver.json", "vsa.json") + (
            ("checkpoint.json",) if with_checkpoint else ()):
        a = (roots["jax"] / f).read_bytes()
        b = (roots["torch"] / f).read_bytes()
        if f == "checkpoint.json":      # epochs carry their save time
            a, b = (json.loads(x) for x in (a, b))
            for d in (a, b):
                d.pop("saved_at", None)
        assert a == b, f
    assert CorpusStore(str(roots["jax"])).load_solver_cache() == cache
    assert JaxStore(str(roots["torch"])).load_solver_cache() == cache
    assert CorpusStore(str(roots["jax"])).load_vsa_doc() == doc
    assert JaxStore(str(roots["torch"])).load_vsa_doc() == doc


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["test", "--json", "--explain"],
    ["test", "--edge", "4:5"],
    ["test", "--block", "5", "--json"],
    ["test", "--require-solved", "12"],
    ["cgc_like", "--vsa", "--explain"],
    ["magicsum_vm", "--json"],
], ids=lambda a: " ".join(a))
def test_kb_solve_matches_jax(argv):
    assert _run(solve_tool.main, argv) == _run(jax_solve.main, argv)


def test_kb_solve_unknown_target_exits_2():
    """The same refusal and the same list of known targets."""
    rc, out, err = _run(solve_tool.main, ["no_such_target"])
    jrc, jout, jerr = _run(jax_solve.main, ["no_such_target"])
    assert (rc, out) == (jrc, jout) == (2, "")
    assert err.split("; known:")[0] == jerr.split("; known:")[0]
    assert err.split("; known:")[1].strip() == ", ".join(NAMES)


@pytest.mark.parametrize("argv", [
    [*NAMES, "--json"],
    [*NAMES, "--json", "--vsa", "--dict"],
    NAMES,
    ["tlvstack_vm", "imgparse_vm", "--vsa", "--dict"],
], ids=["json", "json-vsa-dict", "text", "text-vsa-dict"])
def test_kb_lint_matches_jax(argv):
    assert _run(lint_tool.main, argv) == _run(jax_lint.main, argv)


def test_kb_lint_sarif_matches_jax_but_its_source_anchors():
    """SARIF results anchor on each target's builder source, which is
    the port's own file; everything else is the JAX package's."""
    rc, out, _ = _run(lint_tool.main, ["test", "libtest", "--sarif"])
    jrc, jout, _ = _run(jax_lint.main, ["test", "libtest", "--sarif"])
    assert rc == jrc
    doc, jdoc = json.loads(out), json.loads(jout)
    for d in (doc, jdoc):
        for r in d["runs"][0]["results"]:
            loc = r["locations"][0]["physicalLocation"]
            assert loc["artifactLocation"]["uri"].endswith(
                "models/targets.py")
            del loc["artifactLocation"], loc["region"]
    assert doc == jdoc


def test_kb_lint_gaps_dir_is_refused(tmp_path):
    """``--gaps-dir`` is ported: on a directory with no gap reports it
    lints only the conformance tier, clean, as the JAX tool does
    (tests/test_torch_conformance.py holds the findings)."""
    argv = ["--gaps-dir", str(tmp_path), "--gap-backlog", "0"]
    rc, out, err = _run(lint_tool.main, argv)
    assert (rc, out, err) == _run(jax_lint.main, argv)
    assert rc == 0 and out.startswith("clean: 0 error(s)")
