"""The port's conformance and repair tier (``analysis/conformance.py``,
``analysis/repair.py``, kb-repair and kb-lint's ``--gaps-dir``) against
the JAX package's, on the CPU, the counterparts of
``tests/test_conformance.py``.  Both packages are fed the same gap
reports and must give:

  * the same parsed reports and the same machine-greppable rejects
    (``parse_gap_report``, ``load_gap_reports``);
  * the same clusters, stale and skipped reports (``replay_gaps``);
  * the same blame on ``test_safe`` (``localize``: the guard whose
    constant is the ``D`` byte, found from dataflow) and the same patch
    space (``enumerate_patches``);
  * the same patch or the same unrepairable reason and the same repair
    JSON (``run_repair``), and the same ledger;
  * ``.npz`` files (``save_patched_program``) that either package loads
    into the same program;
  * the same conformance findings (backlog warning, drift error);
  * from the tools: kb-repair ``--probe --apply --json
    --require-repaired`` on ``test_safe`` (status ``repaired``,
    ``installed: test_safe+repaired``) and on the faithful ``test``
    binding, kb-lint ``--gaps-dir ... --sarif`` before and after the
    repair, and ``--auto-repair`` without ``--hybrid`` exiting 2.

The port's kb-repair runs with ``--device cpu`` (the plain version of
``kbz_vm_kernel`` for its proxy verdicts) and its own build of the
native binaries.  Records are compared with wall-clock fields dropped,
paths made relative and native argv reduced to the binary's name.
Tolerance: none."""

import contextlib
import io
import json
import os
import random

import numpy as np
import pytest

from killerbeez_tpu.analysis import conformance as jax_conf
from killerbeez_tpu.analysis import repair as jax_repair
from killerbeez_tpu.fuzzer.cli import main as jax_cli
from killerbeez_tpu.hybrid import gaps as jax_gaps
from killerbeez_tpu.hybrid import registry as jax_registry
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.tools import lint_tool as jax_lint
from killerbeez_tpu.tools import repair_tool as jax_repair_tool
from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE
from killerbeez_tpu_torch.analysis import conformance, repair
from killerbeez_tpu_torch.analysis.dataflow import analyze_dataflow
from killerbeez_tpu_torch.fuzzer.cli import main as cli
from killerbeez_tpu_torch.hybrid import gaps, registry
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.native import build
from killerbeez_tpu_torch.stateful.framing import frame_messages
from killerbeez_tpu_torch.tools import lint_tool, repair_tool
from killerbeez_tpu_torch.utils.fileio import md5_hex

CLOCK = ("t", "ts", "wall_s", "seconds", "repaired_t")
BUFS = (b"ABCD", b"ABCDxx", b"ABCD\x00\x01")
PKGS = {
    "jax": dict(conf=jax_conf, repair=jax_repair, gaps=jax_gaps,
                registry=jax_registry, targets=jax_targets),
    "torch": dict(conf=conformance, repair=repair, gaps=gaps,
                  registry=registry, targets=targets),
}


def _norm(obj, root=None):
    if isinstance(obj, dict):
        return {k: ([os.path.basename(a) for a in v] if k == "argv"
                    else _norm(v, root))
                for k, v in obj.items() if k not in CLOCK}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, root) for v in obj]
    if isinstance(obj, str) and root is not None:
        return obj.replace(str(root), "<root>")
    return obj


def _report(p, buf, *, binding="test_safe", statuses=(0, 0, 0), t=1.0,
            edge=True, **over):
    program = p["targets"].get_target("test")
    kw = dict(md5=md5_hex(buf), kind="crash", binding=binding,
              proxy_target="test", proxy_status=FUZZ_CRASH,
              native_argv=["hybrid-safe"], native_delivery="stdin",
              statuses=list(statuses),
              repro=list(statuses).count(FUZZ_CRASH),
              repeats=len(statuses), t=t, input_bytes=buf,
              edge=(p["gaps"].proxy_trace_edge(program, buf)
                    if edge else None))
    kw.update(over)
    return p["gaps"].make_gap_report(**kw)


def _gap_dir(p, d, bufs=BUFS, **kw):
    idx = p["gaps"].GapIndex(str(d))
    for buf in bufs:
        idx.admit(_report(p, buf, **kw))
    return str(d)


def _soups():
    rng = random.Random(0x18c0de)
    yield from (b"", b"ABCD", b"\x00" * 9, bytes(range(256)))
    for n in (1, 7, 63, 255, 300):
        yield bytes(rng.randrange(256) for _ in range(n))
    yield frame_messages([b"Lpw", b"", b"QA\xff"], 4)


def _parsed(g):
    return (g.md5, g.kind, g.binding, g.proxy_target, g.proxy_status,
            g.native_statuses, g.repro, g.repeats, g.t, g.input, g.edge,
            g.native_cls, g.proxy_cls)


def test_parse_gap_reports_match_jax():
    for i, buf in enumerate(_soups()):
        statuses = [FUZZ_NONE, FUZZ_CRASH, FUZZ_ERROR][: 1 + i % 3]
        rep = _report(PKGS["torch"], buf, statuses=statuses, t=float(i))
        assert rep == _report(PKGS["jax"], buf, statuses=statuses,
                              t=float(i))
        assert _parsed(conformance.parse_gap_report(rep)) == \
            _parsed(jax_conf.parse_gap_report(rep))
    big = _report(PKGS["torch"], b"x" * ((1 << 16) + 1), edge=False)
    assert "input_hex" not in big
    assert _parsed(conformance.parse_gap_report(big)) == \
        _parsed(jax_conf.parse_gap_report(big))


@pytest.mark.parametrize("mutate", [
    dict(schema="kbz-proxy-gap-v0"), dict(md5=""), dict(kind="banana"),
    dict(binding=7), dict(proxy={"target": "test"}), dict(native="nope"),
    dict(native={"statuses": "all-fine"}), dict(t="yesterday"),
    dict(input_hex="zz"), dict(proxy={"target": "test", "status": 2,
                                      "edge": [1, "two"]}),
], ids=lambda m: next(iter(m)))
def test_parse_rejects_match_jax(mutate):
    rep = dict(_report(PKGS["torch"], b"ABCD"), **mutate)
    with pytest.raises(conformance.GapParseError) as e:
        conformance.parse_gap_report(rep)
    with pytest.raises(jax_conf.GapParseError) as je:
        jax_conf.parse_gap_report(rep)
    assert str(e.value) == str(je.value)


def _replay(p, d):
    """What the replay pass makes of a gap directory: the parsed
    reports, the rejects, the clusters, stale and skipped reports."""
    reports, rejects = p["conf"].load_gap_reports(d)
    program = p["targets"].get_target("test")
    res = p["conf"].replay_gaps(program, reports)
    clusters = [(c.edge, c.proxy_cls, c.native_cls,
                 [r.md5 for r in c.reports],
                 [(t.status, t.edges, t.branches) for t in c.traces])
                for c in res.clusters]
    blames = [p["conf"].localize(program, c).as_dict()
              for c in res.clusters]
    return ([_parsed(r) for r in reports], rejects, clusters,
            [r.md5 for r in res.stale],
            [(r.md5, why) for r, why in res.skipped], blames)


def test_replay_and_localize_match_jax(tmp_path):
    """Three counterexamples of one guard, a stale report (the proxy
    already agrees), one the native side never measured, one without
    input bytes, and two malformed files."""
    got = {}
    for pkg, p in PKGS.items():
        d = _gap_dir(p, tmp_path / pkg)
        idx = p["gaps"].GapIndex(d)
        idx.admit(_report(p, b"NOPE", statuses=[FUZZ_NONE] * 3))
        idx.admit(_report(p, b"Q", statuses=[FUZZ_ERROR] * 2))
        old = _report(p, b"ABCDold")
        del old["input_hex"]
        idx.admit(old)
        (tmp_path / pkg / "bogus.json").write_text("{")
        (tmp_path / pkg / "wrong.json").write_text('{"schema": "nope"}')
        got[pkg] = _replay(p, d)
    assert got["torch"] == got["jax"]
    [blame] = got["torch"][5]
    [fact] = [f for f in analyze_dataflow(targets.get_target("test"))
              .branches if f.const == ord("D")]
    assert blame["pc"] == fact.pc and blame["const"] == ord("D")


def test_patch_space_matches_jax(tmp_path):
    got = {}
    for pkg, p in PKGS.items():
        program = p["targets"].get_target("test")
        reports, _ = p["conf"].load_gap_reports(
            _gap_dir(p, tmp_path / pkg))
        cluster = p["conf"].replay_gaps(program, reports).clusters[0]
        blame = p["conf"].localize(program, cluster)
        patches = p["repair"].enumerate_patches(program, blame)
        got[pkg] = [(x.desc, x.as_dict()) for x in patches] + [
            np.asarray(p["repair"].apply_patch(program, x).instrs).tolist()
            for x in patches]
    assert got["torch"] == got["jax"]


CASES = {
    # the D-check divergence: repaired by a verified patch
    "repaired": dict(bufs=BUFS),
    # a loop-free proxy cannot be bent to hang: honestly unrepairable
    "out-of-model": dict(bufs=(b"ABCD",), binding="test",
                         statuses=[FUZZ_HANG] * 3),
    # no reports for this binding, and a foreign one
    "foreign": dict(bufs=(b"ABCD",), binding="someone-else"),
}


def _run_repair(p, d, case):
    kw = dict(CASES[case])
    bufs = kw.pop("bufs")
    _gap_dir(p, d, bufs, **kw)
    binding = p["registry"].get_binding(kw.get("binding", "test_safe")
                                        if case != "foreign"
                                        else "test_safe")
    result, patched = p["repair"].run_repair(binding, str(d), now=7.0)
    n = p["repair"].write_repair_ledger(str(d), result)
    return result, patched, n, p["gaps"].load_ledger(str(d))


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_repair_matches_jax(tmp_path, case):
    got = {}
    for pkg, p in PKGS.items():
        result, patched, n, ledger = _run_repair(p, tmp_path / pkg, case)
        got[pkg] = (_norm(result, tmp_path / pkg), n, ledger,
                    None if patched is None else
                    np.asarray(patched.instrs).tolist())
    assert got["torch"] == got["jax"]
    want = {"repaired": "repaired", "out-of-model": "unrepairable",
            "foreign": "no-gaps"}[case]
    assert got["torch"][0]["status"] == want


def test_saved_program_loads_alike_in_both(tmp_path):
    """Each package's .npz loads in either package into the same
    program, and the patched proxy no longer crashes on ABCD."""
    progs = {}
    for pkg, p in PKGS.items():
        _, patched, _, _ = _run_repair(p, tmp_path / pkg, "repaired")
        path = str(tmp_path / f"{pkg}.npz")
        p["repair"].save_patched_program(patched, path)
        for loader in ("jax", "torch"):
            prog = PKGS[loader]["targets"].load_program_file(path)
            progs[(pkg, loader)] = (
                np.asarray(prog.instrs).tolist(), prog.name,
                prog.mem_size, prog.max_steps, prog.n_blocks,
                list(prog.block_ids), [list(m) for m in prog.modules],
                np.asarray(prog.edge_table).tolist())
    assert len({json.dumps(v) for v in progs.values()}) == 1
    assert progs[("torch", "torch")][1] == "test+repaired"
    loaded = targets.load_program_file(str(tmp_path / "jax.npz"))
    from killerbeez_tpu_torch.analysis.solver import concrete_run
    assert conformance.verdict_class(
        concrete_run(loaded, b"ABCD").status) == "ok"


def test_conformance_lint_matches_jax(tmp_path):
    """The backlog warning at threshold 0 (none at 8), cleared by the
    ledger, then the drift error once a newer gap hits the repaired
    site."""
    got = {}
    for pkg, p in PKGS.items():
        d = _gap_dir(p, tmp_path / pkg)
        lint = p["conf"].conformance_lint
        steps = [lint(d, 8), lint(d, 0)]
        binding = p["registry"].get_binding("test_safe")
        result, _ = p["repair"].run_repair(binding, d, now=7.0)
        p["repair"].write_repair_ledger(d, result)
        steps.append(lint(d, 0))
        p["gaps"].GapIndex(d).admit(_report(p, b"ABCDQQ", t=1000.0))
        steps.append(lint(d, 99))
        got[pkg] = [[_norm(f.as_dict(), tmp_path / pkg) for f in s]
                    for s in steps]
    assert got["torch"] == got["jax"]
    codes = [[f["code"] for f in s] for s in got["torch"]]
    assert codes == [[], ["proxy-gap-backlog"], [],
                     ["conformance-drift"]]


# -- the tools -----------------------------------------------------------


@pytest.fixture(autouse=True)
def _forget_repaired_bindings():
    """A test that installs ``test_safe+repaired`` takes it out of both
    registries again, so no later test in the process sees it."""
    yield
    for reg in (registry, jax_registry):
        reg._BINDINGS.pop("test_safe+repaired", None)


@pytest.fixture(scope="module")
def port_bin():
    try:
        build.build_corpus(["test-plain", "hybrid-safe"])
    except RuntimeError as e:
        pytest.skip(f"native build unavailable: {e}")


def _tool(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _sarif(main, d):
    rc, out, _ = _tool(main, ["--gaps-dir", d, "--gap-backlog", "0",
                              "--sarif"])
    doc = json.loads(out)
    for r in doc["runs"][0]["results"]:
        loc = r["locations"][0]["physicalLocation"]
        # anchored on the binding's proxy source: each package's own
        assert loc["artifactLocation"]["uri"].endswith("models/targets.py")
        assert loc["region"]["startLine"] > 1
        del loc["artifactLocation"], loc["region"]
        r["properties"]["gaps_dir"] = "<gaps>"
        r["message"]["text"] = r["message"]["text"].replace(d, "<gaps>")
    return rc, doc


@pytest.mark.parametrize("binding", ["test_safe", "test"])
def test_kb_repair_probe_apply_matches_jax(corpus_bin, port_bin, tmp_path,
                                           binding):
    """kb-repair ``--probe --apply --json --require-repaired``: the probe
    mints the same gap reports by running both tiers on solver
    witnesses, the repair the same patch (test_safe) or finds nothing
    to repair (test: every witness confirms), the same exit code;
    kb-lint's SARIF over the gap directory is the same before and after
    the repair, and clean after it."""
    got = {}
    for pkg, (rmain, lmain) in {
            "jax": (jax_repair_tool.main, jax_lint.main),
            "torch": (repair_tool.main, lint_tool.main)}.items():
        d = str(tmp_path / pkg / "gaps")
        argv = ["--binding", binding, "--gaps-dir", d, "--probe", "--json",
                "--apply", "--require-repaired"]
        if pkg == "torch":
            argv += ["--device", "cpu"]
        rc, out, err = _tool(rmain, argv)
        result = _norm(json.loads(out), tmp_path / pkg)
        after = _sarif(lmain, d)
        got[pkg] = (rc, result, after, _norm(
            gaps.load_ledger(d), tmp_path / pkg))
    assert got["torch"] == got["jax"]
    rc, result, (lint_rc, sarif), _ = got["torch"]
    if binding == "test_safe":
        assert rc == 0 and result["status"] == "repaired"
        assert result["installed"] == "test_safe+repaired"
        assert "test_safe+repaired" in registry.binding_names()
        assert not sarif["runs"][0]["results"]
    else:
        assert rc == 1 and result["status"] == "no-gaps"


def test_kb_lint_gaps_dir_sarif_matches_jax(tmp_path):
    """Before any repair the backlog warning is the one result, anchored
    on the binding's proxy source line."""
    got = {}
    for pkg, lmain in (("jax", jax_lint.main), ("torch", lint_tool.main)):
        got[pkg] = _sarif(lmain, _gap_dir(PKGS[pkg], tmp_path / pkg))
    assert got["torch"] == got["jax"]
    rc, doc = got["torch"]
    assert rc == 0
    assert [r["ruleId"] for r in doc["runs"][0]["results"]] == \
        ["proxy-gap-backlog"]


def test_auto_repair_needs_hybrid_in_both(tmp_path):
    seed = tmp_path / "seed"
    seed.write_bytes(b"AAAA")
    argv = ["file", "jit_harness", "havoc", "-i", '{"target": "test"}',
            "-sf", str(seed), "-o", str(tmp_path / "out"), "-n", "16",
            "-b", "16", "--auto-repair"]
    rc, _, err = _tool(cli, argv + ["--device", "cpu"])
    jrc, _, jerr = _tool(jax_cli, argv)
    assert rc == jrc == 2
    assert "--hybrid" in err and err.strip() == jerr.strip()
