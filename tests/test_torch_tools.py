"""The port's merger, minimize and picker tools (``python -m
killerbeez_tpu_torch.tools.<name>``), its showmap's and picker's
session sections, and the lint's session checks, against the JAX
package's, on the CPU.  Each case mirrors one of ``tests/test_tools.py``
or ``tests/test_stateful.py``: host targets run the JAX fixture
``corpus_bin``'s binaries for both packages; KBVM targets run with
``--device cpu``.  The same inputs must give the same output files,
reports and findings.  Tolerance: none."""

import json

import numpy as np
import pytest
import torch

from killerbeez_tpu import analysis as JA
from killerbeez_tpu.models import compiler as jcomp
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_stateful as jts
from killerbeez_tpu.stateful import StatefulSpec as JSpec
from killerbeez_tpu.tools import merger as jmerger
from killerbeez_tpu.tools import minimize as jminimize
from killerbeez_tpu.tools import picker as jpicker
from killerbeez_tpu.tools import showmap as jshowmap
from killerbeez_tpu_torch import MAP_SIZE
from killerbeez_tpu_torch import analysis as TA
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.instrumentation.factory import (
    instrumentation_factory,
)
from killerbeez_tpu_torch.models import compiler as tcomp
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.models import targets_stateful as ts
from killerbeez_tpu_torch.stateful import StatefulSpec, frame_messages
from killerbeez_tpu_torch.tools import merger, minimize, picker, showmap
from killerbeez_tpu_torch.tools.tracer import (
    read_edge_file, read_pair_file, write_pair_file,
)
from killerbeez_tpu_torch.utils.serialization import decode_array

torch.set_num_threads(1)

TCP = {"target": "tcp_like", "stateful": 1}


def _write(path, data: bytes) -> str:
    path.write_bytes(data)
    return str(path)


def _frame(msgs):
    return frame_messages(msgs, 4)


def _afl_state(corpus_bin, tmp_path, seed: bytes, name: str):
    """One afl exec of the port on the test fixture; its state file."""
    instr = instrumentation_factory("afl", None, device="cpu")
    drv = driver_factory("stdin", json.dumps({"path": corpus_bin("test")}),
                         instr, None, device="cpu")
    drv.test_input(seed)
    path = _write(tmp_path / name, instr.get_state().encode())
    cov = instr.coverage_bytes()
    drv.cleanup()
    instr.cleanup()
    return path, cov


# ---------------------------------------------------------------------------
# merger
# ---------------------------------------------------------------------------


def test_merger_folds_afl_coverage_as_jax(corpus_bin, tmp_path):
    s1, cov1 = _afl_state(corpus_bin, tmp_path, b"zzzz", "s1")
    s2, cov2 = _afl_state(corpus_bin, tmp_path, b"ABCz", "s2")
    out, jout = str(tmp_path / "m"), str(tmp_path / "jm")
    assert merger.main(["afl", s1, s2, "-o", out, "--device", "cpu"]) == 0
    assert jmerger.main(["afl", s1, s2, "-o", jout]) == 0
    assert open(out).read() == open(jout).read()
    instr = instrumentation_factory("afl", None, device="cpu")
    instr.set_state(open(out).read())
    assert max(cov1, cov2) <= instr.coverage_bytes() < cov1 + cov2
    instr.cleanup()


def test_merger_folds_session_states_as_jax(tmp_path):
    """Two stateful jit_harness states (tcp_like) fold to the JAX
    merger's state, virgin_state included; a state under another
    session spec is refused (exit 2)."""
    files = []
    for i, msgs in enumerate(([b"S\x10", b"A\x11"], [b"S\x20", b"D\x01"])):
        instr = instrumentation_factory("jit_harness", json.dumps(TCP),
                                        device="cpu")
        instr.enable(_frame(msgs))
        files.append(_write(tmp_path / f"s{i}", instr.get_state().encode()))
    out, jout = str(tmp_path / "m"), str(tmp_path / "jm")
    opts = json.dumps(TCP)
    assert merger.main(["jit_harness", *files, "-i", opts, "-o", out,
                        "--device", "cpu"]) == 0
    assert jmerger.main(["jit_harness", *files, "-i", opts,
                         "-o", jout]) == 0
    assert open(out).read() == open(jout).read()
    assert "virgin_state" in json.loads(open(out).read())
    bad = json.dumps({**TCP, "state_reg": 6})
    assert merger.main(["jit_harness", *files, "-i", bad, "-o", out,
                        "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# minimize
# ---------------------------------------------------------------------------


def test_greedy_edge_cover_matches_jax():
    sets = {"big": {1, 2, 3, 4}, "sub": {1, 2}, "extra": {5},
            "dup_extra": {5}}
    kept = minimize.greedy_edge_cover(sets)
    assert kept == jminimize.greedy_edge_cover(sets)
    assert kept[0] == "big" and "sub" not in kept and "dup_extra" in kept
    rng = np.random.default_rng(3)
    sets = {f"f{i:02d}": set(rng.integers(0, 64, rng.integers(1, 20)))
            for i in range(40)}
    assert minimize.greedy_edge_cover(sets) == \
        jminimize.greedy_edge_cover(sets)


@pytest.mark.parametrize("pairs", [False, True], ids=["slots", "pairs"])
def test_minimize_cli_matches_jax(pairs, tmp_path):
    rng = np.random.default_rng(11)
    files = []
    for i in range(12):
        p = tmp_path / f"in{i:02d}.txt"
        if pairs:
            write_pair_file(str(p), {tuple(e) for e in
                                     rng.integers(0, 9, (6, 2))})
        else:
            p.write_text("".join(f"{e}:{c}\n" for e, c in zip(
                rng.choice(64, 6, replace=False), rng.integers(1, 9, 6))))
        files.append(str(p))
    # a subset of the first file: the cover never keeps it
    sub = tmp_path / "sub.txt"
    sub.write_text("".join(open(files[0]).read().splitlines(True)[:2]))
    files.append(str(sub))
    flag = ["-p"] if pairs else []
    out, jout = str(tmp_path / "k"), str(tmp_path / "jk")
    assert minimize.main([*files, *flag, "-o", out]) == 0
    assert jminimize.main([*files, *flag, "-o", jout]) == 0
    assert open(out).read() == open(jout).read()
    kept, covered = minimize.minimize_edge_files(files, pairs)
    assert (kept, covered) == jminimize.minimize_edge_files(files, pairs)
    assert kept and str(sub) not in kept
    reader = read_pair_file if pairs else read_edge_file
    from killerbeez_tpu.tools import tracer as jtracer
    jreader = jtracer.read_pair_file if pairs else jtracer.read_edge_file
    assert all(reader(f) == jreader(f) for f in files)


# ---------------------------------------------------------------------------
# picker
# ---------------------------------------------------------------------------


def _picker(tool, tmp_path, name, argv):
    out = str(tmp_path / name)
    extra = ["--device", "cpu"] if tool is picker else []
    assert tool.main([*argv, "-o", out, *extra]) == 0
    return json.load(open(out))


def test_picker_afl_report_matches_jax(corpus_bin, tmp_path):
    seeds = [_write(tmp_path / f"seed{i}", s)
             for i, s in enumerate((b"zzzz", b"ABzz"))]
    argv = ["file", "afl", *seeds, "-n", "3", "-d",
            json.dumps({"path": corpus_bin("test"), "arguments": "@@"})]
    rep = _picker(picker, tmp_path, "t.json", argv)
    assert rep == _picker(jpicker, tmp_path, "j.json", argv)
    assert rep["nondeterministic_bytes"] == 0
    assert rep["classification"] == "path_per_file"
    mask = decode_array(rep["ignore_bytes"])
    assert mask.shape == (MAP_SIZE,) and not mask.any()


def test_picker_batched_matches_single_exec(corpus_bin):
    instr = instrumentation_factory("afl", None, device="cpu")
    drv = driver_factory("stdin", json.dumps({"path": corpus_bin("test")}),
                         instr, None, device="cpu")
    seeds = [b"zzzz", b"ABzz"]
    batched = picker.collect_traces(drv, instr, seeds, 3)
    orig = drv._host_exec_spec
    drv._host_exec_spec = lambda: (_ for _ in ()).throw(
        NotImplementedError())
    single = picker.collect_traces(drv, instr, seeds, 3)
    drv._host_exec_spec = orig
    np.testing.assert_array_equal(batched, single)
    drv.cleanup()
    instr.cleanup()


def test_picker_per_module_masks(corpus_bin, tmp_path):
    """The ndlib fixture's main binary is deterministic while its
    shared library branches on the clock: only the library partition
    is flagged, with partition-local masks (the JAX test's checks; the
    clock makes the two packages' bytes differ run to run)."""
    seed = _write(tmp_path / "seed", b"NQxx")
    rep = _picker(picker, tmp_path, "mods.json", [
        "file", "afl", seed, "-n", "6", "-i", '{"modules": 1}', "-d",
        json.dumps({"path": corpus_bin("ndlib"), "arguments": "@@"})])
    mods = rep["modules"]
    lib = next(v for k, v in mods.items() if "libnd1" in k)
    main_mod = next(v for k, v in mods.items() if "ndlib" in k)
    assert lib["classification"] == "multi_path_same_file"
    assert lib["nondeterministic_bytes"] > 0
    assert main_mod["nondeterministic_bytes"] == 0
    lo, hi = lib["range"]
    assert decode_array(lib["ignore_bytes"]).shape == (hi - lo,)
    nz = np.flatnonzero(decode_array(rep["ignore_bytes"]))
    assert len(nz) and (nz >= lo).all() and (nz < hi).all()


def test_mask_derivation_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(4):
        traces = np.zeros((3, 4, MAP_SIZE), np.uint8)
        idx = rng.integers(0, MAP_SIZE, 40)
        traces[:, :, idx] = rng.integers(0, 3, (3, 4, 40))
        assert np.array_equal(picker.derive_ignore_mask(traces),
                              jpicker.derive_ignore_mask(traces))
        assert picker.classify_target(traces) == \
            jpicker.classify_target(traces)
    assert picker.classify_target(np.zeros((1, 2, 8), np.uint8)) == \
        jpicker.CLASS_NO_PATH


@pytest.mark.parametrize("iopts,seeds", [
    ({"target": "test"}, [b"ABzz", b"zzzz"]),
    (TCP, "sessions"),
], ids=["test", "tcp_like-stateful"])
def test_picker_kbvm_report_matches_jax(iopts, seeds, tmp_path):
    """KBVM targets: the report with its static section, and under
    --stateful the state section (states reached, pairs, per seed)."""
    if seeds == "sessions":
        seeds = [ts.framed_seed("tcp_like"),
                 _frame([b"S\x10", b"A\x11", b"D\x05A"])]
    files = [_write(tmp_path / f"s{i}", s) for i, s in enumerate(seeds)]
    argv = ["file", "jit_harness", *files, "-n", "2", "-i",
            json.dumps(iopts)]
    rep = _picker(picker, tmp_path, "t.json", argv)
    assert rep == _picker(jpicker, tmp_path, "j.json", argv)
    assert rep["static"]
    if "stateful" in iopts:
        st = rep["state"]
        assert st["states_reached"][0] == 0
        assert len(st["states_reached"]) >= 2 and st["pairs"]
    else:
        assert "state" not in rep


# ---------------------------------------------------------------------------
# showmap's session section
# ---------------------------------------------------------------------------


def test_showmap_state_section_matches_jax(tmp_path, capsys):
    seed = _write(tmp_path / "seq", ts.framed_seed("tcp_like"))
    argv = ["file", "jit_harness", "-sf", seed, "-i", json.dumps(TCP)]
    got = []
    for tool, extra in ((showmap, ["--device", "cpu"]), (jshowmap, [])):
        assert tool.main(argv + extra) == 0
        cap = capsys.readouterr()
        state = [ln.split(" - INFO - ", 1)[1] for ln in
                 cap.err.splitlines() if "state coverage" in ln]
        got.append((cap.out, state))
    assert got[0] == got[1]
    assert got[0][0] and len(got[0][1]) == 1
    assert "3 protocol state(s) [0, 1, 2]" in got[0][1][0]


# ---------------------------------------------------------------------------
# the lint's session checks (analysis/lint.py with stateful/protocol.py)
# ---------------------------------------------------------------------------


def _findings(mod, prog, spec):
    return [f.as_dict() for f in mod.lint_program(prog, stateful=spec)]


def test_lint_downgrades_session_only_blocks_as_jax():
    prog = targets.get_target("session_auth")
    jprog = jax_targets.get_target("session_auth")
    spec = ts.get_stateful_spec("session_auth")
    got = _findings(TA, prog, spec)
    assert got == _findings(JA, jprog, jts.get_stateful_spec(
        "session_auth"))
    plain = [f for f in TA.lint_program(prog) if f.code == "dead-block"]
    assert plain and not [f for f in got if f["code"] == "dead-block"]
    only = [f for f in got if f["code"] == "session-only-block"]
    assert {f["data"]["block"] for f in only} == \
        {f.data["block"] for f in plain}
    assert not [f for f in got if f["code"] == "state-unreachable"]


def _proto(mod, clip):
    a = mod.Assembler("clipproto" if clip else "badproto", mem_size=8,
                      max_steps=64)
    a.block()
    if clip:
        a.ldi(7, 12)
        a.halt(0)
        return a.build(block_seed=0xC11)
    a.ldi(1, 0)
    a.ldb(1, 1)
    a.ldi(2, ord("A"))
    a.br("eq", 1, 2, "adv")
    a.ldi(2, 5)
    a.br("eq", 7, 2, "deep")
    a.jmp("exit")
    a.label("adv")
    a.block()
    a.ldi(7, 1)
    a.halt(0)
    a.label("deep")
    a.block()
    a.halt(9)
    a.label("exit")
    a.block()
    a.halt(0)
    return a.build(block_seed=0xBAD)


@pytest.mark.parametrize("clip,code,key,value", [
    (False, "state-unreachable", "state", 5),
    (True, "state-clip", "value", 12),
], ids=["state-unreachable", "state-clip"])
def test_lint_session_checks_match_jax(clip, code, key, value):
    m_max = 2 if clip else 4
    got = _findings(TA, _proto(tcomp, clip), StatefulSpec(m_max, 8, 7))
    assert got == _findings(JA, _proto(jcomp, clip), JSpec(m_max, 8, 7))
    hits = [f for f in got if f["code"] == code]
    assert hits and hits[0]["data"][key] == value


def test_kb_lint_resolves_stateful_targets_as_jax(capsys):
    from killerbeez_tpu.tools import lint_tool as jlint
    from killerbeez_tpu_torch.tools import lint_tool
    argv = ["session_auth", "tcp_like", "--json"]
    rc = lint_tool.main(argv)
    out = capsys.readouterr().out
    assert (rc, out) == (jlint.main(argv), capsys.readouterr().out)
    assert "session-only-block" in out
