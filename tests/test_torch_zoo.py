"""The port's generated target zoo (``models/zoo.py`` and kb-zoo)
against the JAX package's, on the CPU.  Each case mirrors one of
``tests/test_zoo.py``: every family instance generates the JAX
package's program, seed, witness, deep edge and grammar, and certifies
with the same report (lint clean, benign seed misses the deep edge and
exits clean, the witness crashes through it, the solver's verdict); the
deep edge is crash-coincident and owns its AFL slot; names resolve
through the target registry and bad names fail with JAX's messages;
kb-zoo's list, certify and generate print and write what JAX's kb-zoo
does.  Tolerance: none."""

import json
import os

import numpy as np
import pytest

from killerbeez_tpu.models import zoo as jax_zoo
from killerbeez_tpu.tools import zoo_tool as jax_zoo_tool
from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_NONE
from killerbeez_tpu_torch.analysis.solver import concrete_run
from killerbeez_tpu_torch.models.targets import (
    get_target, load_program_from_options,
)
from killerbeez_tpu_torch.models.zoo import (
    GATED_NAMES, _tokens, build_zoo, certify_zoo, parse_zoo_name,
    zoo_families, zoo_name,
)
from killerbeez_tpu_torch.tools import zoo_tool

ALL_INSTANCES = list(GATED_NAMES) + [
    "zoo:tlv:depth=1,bug=0",
    "zoo:tlv:depth=4,bug=2",
    "zoo:chain:width=1,bug=0",
    "zoo:chain:width=6,bug=4",
    "zoo:cksum:style=xor,bug=0",
]


@pytest.mark.parametrize("name", ALL_INSTANCES)
def test_zoo_instance_matches_jax_and_certifies(name):
    mine, ref = build_zoo(name), jax_zoo.build_zoo(name)
    assert mine.name == ref.name and mine.params == ref.params
    for f in ("instrs", "edge_from", "edge_to", "edge_slot"):
        np.testing.assert_array_equal(np.asarray(getattr(mine.program, f)),
                                      np.asarray(getattr(ref.program, f)))
    assert (mine.seed, mine.crash, mine.deep_edge) == \
        (ref.seed, ref.crash, ref.deep_edge)
    assert mine.grammar.to_json() == ref.grammar.to_json()
    r = certify_zoo(name)
    assert r == jax_zoo.certify_zoo(name)
    assert r["certified"] and r["seed_benign"] and r["witness_crashes"]
    assert not r["lint_errors"]


@pytest.mark.parametrize("name", GATED_NAMES)
def test_zoo_deep_edge_is_crash_coincident(name):
    t = build_zoo(name)
    seed_tr = concrete_run(t.program, t.seed)
    crash_tr = concrete_run(t.program, t.crash)
    assert seed_tr.status == FUZZ_NONE
    assert t.deep_edge not in seed_tr.edges
    assert crash_tr.status == FUZZ_CRASH
    assert t.deep_edge in crash_tr.edges


@pytest.mark.parametrize("name", GATED_NAMES)
def test_zoo_deep_edge_has_collision_free_slot(name):
    t = build_zoo(name)
    ef = np.asarray(t.program.edge_from)
    et = np.asarray(t.program.edge_to)
    slots = np.asarray(t.program.edge_slot)
    deep = [e for e in range(len(et))
            if (int(ef[e]), int(et[e])) == t.deep_edge]
    assert deep
    other = {int(slots[e]) for e in range(len(et)) if e not in deep}
    assert {int(slots[e]) for e in deep} - other


def test_zoo_generation_deterministic():
    a = build_zoo("zoo:tlv:depth=2,bug=1")
    b = build_zoo("zoo:tlv:depth=2,bug=1")
    assert np.array_equal(np.asarray(a.program.instrs),
                          np.asarray(b.program.instrs))
    assert a.seed == b.seed and a.crash == b.crash
    assert a.grammar.to_json() == b.grammar.to_json()


def test_zoo_grammar_carries_trigger_token():
    for name in GATED_NAMES:
        t = build_zoo(name)
        _, trigger = _tokens(t.params["bug"])
        alphas = [f for r in t.grammar.rules.values()
                  for f in r.fields if f.kind == "token"]
        assert alphas and any(trigger in a.alphabet for a in alphas)
        assert trigger in t.crash and trigger not in t.seed


def test_zoo_names_roundtrip_and_defaults():
    fam, params = parse_zoo_name("zoo:tlv")
    assert fam == "tlv" and params == zoo_families()["tlv"]
    assert parse_zoo_name(zoo_name(fam, params))[1] == params
    fam, params = parse_zoo_name("zoo:cksum:bug=2")
    assert params["style"] == "sum" and params["bug"] == 2
    assert zoo_families() == jax_zoo.zoo_families()


@pytest.mark.parametrize("bad,msg", [
    ("tlv:depth=2", "not a zoo target"),
    ("zoo:nosuch", "unknown zoo family"),
    ("zoo:tlv:nope=1", "bad zoo parameter"),
    ("zoo:tlv:depth=99", "out of range"),
    ("zoo:cksum:style=crc", "sum or xor"),
])
def test_zoo_bad_names_fail_loudly(bad, msg):
    errors = []
    for build, parse in ((build_zoo, parse_zoo_name),
                         (jax_zoo.build_zoo, jax_zoo.parse_zoo_name)):
        with pytest.raises(ValueError, match=msg) as e:
            build(bad) if bad.startswith("zoo:") else parse(bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_zoo_resolves_through_target_registry():
    prog = get_target("zoo:chain:width=3,bug=1")
    assert prog.name.startswith("zoo_chain")
    with pytest.raises(ValueError, match="unknown zoo family"):
        get_target("zoo:bogus")


@pytest.mark.parametrize("argv", [
    ["list"], ["certify"], ["certify", "--json", "zoo:tlv:depth=1,bug=0"],
    ["certify", "zoo:chain:width=2,bug=0", "zoo:cksum:style=xor,bug=1"],
], ids=["list", "certify", "certify-json", "certify-names"])
def test_kb_zoo_prints_what_jax_prints(argv, capsys):
    assert zoo_tool.main(argv) == 0
    mine = capsys.readouterr().out
    assert jax_zoo_tool.main(argv) == 0
    assert mine == capsys.readouterr().out
    if argv == ["list"]:
        for fam in zoo_families():
            assert fam in mine
        for n in GATED_NAMES:
            assert n in mine


def test_kb_zoo_generate_bundle(tmp_path, capsys):
    outs = {}
    for pkg, tool in (("torch", zoo_tool), ("jax", jax_zoo_tool)):
        out = str(tmp_path / pkg)
        assert tool.main(["generate", "zoo:cksum:style=sum,bug=1",
                          "--out", out]) == 0
        outs[pkg] = out
    for f in ("seed", "crash", "grammar.json", "certificate.json"):
        with open(os.path.join(outs["torch"], f), "rb") as a, \
                open(os.path.join(outs["jax"], f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(outs["torch"], "certificate.json")) as f:
        assert json.load(f)["certified"]
    # the npz round-trips through the port's program_file loader
    prog = load_program_from_options(
        {"program_file": os.path.join(outs["torch"], "program.npz")}, "x")
    np.testing.assert_array_equal(
        np.asarray(prog.instrs),
        np.asarray(build_zoo("zoo:cksum:style=sum,bug=1").program.instrs))
    with open(os.path.join(outs["torch"], "crash"), "rb") as f:
        assert concrete_run(prog, f.read()).status == FUZZ_CRASH
