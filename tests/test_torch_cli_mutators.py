"""The port's CLI against the JAX package's for every mutator but
grammar (``test_torch_grammar_campaigns.py`` has its CLI runs), on
``tlvstack_vm`` at ``-b 64``: the same md5 sets under
crashes/, hangs/ and new_paths/ and the same ``-isd`` and ``-msd``
state strings, with every finite walk run to exhaustion (``-n -1``,
exit 0, its last batch clamped to what is left and padded as the JAX
package pads it); the randomized ones also at the default ``-fb``
(corpus feedback every 8 batches) with ``PIPELINE_DEPTH = 1`` on both
``Fuzzer`` classes, where their ``scheduler_pick`` sequences and
``fuzzer_stats`` counters must agree too (tests/test_torch_feedback.py
says why the depth is pinned).  ``-G`` stands down and ``--mesh``
refuses for a mutator without a fused candidate stream, as in the JAX
package.  Tolerance: none."""

import json
import os

import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.models.targets_cgc import tlvstack_vm_seed
from killerbeez_tpu.utils.serialization import encode_mem_array
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

COUNTERS = ("execs_done", "paths_total", "unique_crashes", "unique_hangs")
SHORT = tlvstack_vm_seed()[:8]     # afl's deterministic stages: 2740

# (mutator, -m options, seed, -n): -n -1 runs a finite walk out
FINITE = [
    ("nop", {}, None, "300"),
    ("bit_flip", {"num_bits": 1}, None, "-1"),
    ("bit_flip", {"num_bits": 32}, None, "-1"),
    ("arithmetic", {}, SHORT, "-1"),
    ("interesting_value", {}, None, "-1"),
    ("dictionary", {"target": "tlvstack_vm"}, SHORT, "-1"),
    ("manager", {"mutators": ["bit_flip", "bit_flip"], "framed": 1},
     [b"STK1", b"\x01\x05"], "-1"),
]
RANDOMIZED = [
    ("zzuf", {"seed": 3, "ratio_bits": 0.02}, None),
    ("ni", {"seed": 3}, None),
    ("honggfuzz", {"seed": 3}, None),
    ("splice", {"seed": 3}, None),
    ("afl", {"seed": 3}, SHORT),
    ("manager", {"mutators": ["bit_flip", "havoc"],
                 "mutator_options": [None, {"seed": 3}], "framed": 1},
     [b"STK1", b"\x01\x05\x01\x07"]),
]


def _ids(cases):
    return [f"{c[0]}-{i}" for i, c in enumerate(cases)]


def _seed_file(tmp, seed):
    path = tmp / "seed.bin"
    if seed is None:
        seed = tlvstack_vm_seed()
    elif isinstance(seed, list):
        seed = encode_mem_array(seed).encode()
    path.write_bytes(seed)
    return path


def _corpus(tmp):
    d = tmp / "partners"
    d.mkdir()
    s = tlvstack_vm_seed()
    (d / "a").write_bytes(s[::-1])
    (d / "b").write_bytes(s[:12] + b"\x02\x00\x07\x00" * 3)
    return d


def _run(pkg, tmp, mutator, mopts, seed, *extra):
    out = tmp / pkg
    iopts = {"target": "tlvstack_vm",
             "engine": "xla" if pkg == "jax" else "torch"}
    argv = ["file", "jit_harness", mutator, "-sf", str(seed), "-m",
            json.dumps(mopts), "-b", "64", "-o", str(out), "-i",
            json.dumps(iopts), "-isd", f"{out}.isd", "-msd", f"{out}.msd",
            *extra]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    assert (jax_main if pkg == "jax" else main)(argv) == 0
    return {
        "findings": {d: sorted(os.listdir(out / d))
                     for d in ("crashes", "hangs", "new_paths")},
        "isd": open(f"{out}.isd").read(),
        "msd": open(f"{out}.msd").read(),
    }, out


@pytest.mark.parametrize("mutator,mopts,seed,n", FINITE, ids=_ids(FINITE))
def test_finite_walks_match_jax(mutator, mopts, seed, n, tmp_path, capfd):
    seed = _seed_file(tmp_path, seed)
    ref, _ = _run("jax", tmp_path, mutator, mopts, seed, "-n", n,
                  "--no-stats")
    capfd.readouterr()
    got, _ = _run("torch", tmp_path, mutator, mopts, seed, "-n", n)
    assert got == ref
    assert got["findings"]["new_paths"]
    if n == "-1":
        assert "mutator exhausted" in "".join(capfd.readouterr())
        state = json.loads(got["msd"])
        assert state["iteration"] > 0


def _summary(out, got):
    stats = {}
    with open(out / "fuzzer_stats") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k.strip() in COUNTERS:
                stats[k.strip()] = v.strip()
    with open(out / "events.jsonl") as f:
        picks = [(e["arm"], e["rotation"]) for e in map(json.loads, f)
                 if e["type"] == "scheduler_pick"]
    return {**got, "counters": stats, "picks": picks}


@pytest.mark.parametrize("mutator,mopts,seed", RANDOMIZED,
                         ids=_ids(RANDOMIZED))
def test_randomized_mutators_match_jax(mutator, mopts, seed, tmp_path):
    """At -fb 0 and at the default -fb (a rotation after 8 and 16
    batches, the last batch a short tail)."""
    if mutator == "splice":
        mopts = {**mopts, "corpus_dir": str(_corpus(tmp_path))}
    seed = _seed_file(tmp_path, seed)
    for fb in (["-fb", "0", "-n", "1000"], ["-n", "1100"]):
        runs = {}
        with pytest.MonkeyPatch.context() as mp:
            for cls in (JaxFuzzer, Fuzzer):
                mp.setattr(cls, "PIPELINE_DEPTH", 1)
            for pkg in ("jax", "torch"):
                d = tmp_path / f"{pkg}{len(fb)}"
                d.mkdir()
                got, out = _run(pkg, d, mutator, mopts, seed, *fb)
                runs[pkg] = _summary(out, got)
        assert runs["torch"] == runs["jax"]
        assert runs["torch"]["findings"]["new_paths"]
        if len(fb) == 2:
            assert [r for _, r in runs["torch"]["picks"]] == [1, 2]


def test_generations_stand_down_and_mesh_refuses(tmp_path, capfd):
    seed = _seed_file(tmp_path, None)
    got, _ = _run("torch", tmp_path, "zzuf", {"seed": 1}, seed, "-n",
                  "256", "-G", "4", "-fb", "0")
    assert "--generations stood down" in "".join(capfd.readouterr())
    ref, _ = _run("jax", tmp_path, "zzuf", {"seed": 1}, seed, "-n",
                  "256", "-G", "4", "-fb", "0", "--no-stats")
    assert got == ref
    argv = ["file", "jit_harness", "zzuf", "-sf", str(seed), "-b", "64",
            "-n", "64", "--mesh", "1,1", "--device", "cpu", "-i",
            '{"target": "tlvstack_vm"}', "-o", str(tmp_path / "m")]
    assert main(argv) == 2


def test_grammar_is_refused(tmp_path, capsys):
    """The grammar mutator is ported; what both CLIs refuse is an
    ``auto`` grammar without the target to derive it from."""
    errors = []
    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        argv = ["file", "jit_harness", "grammar", "-ss", "ABCD", "-i",
                '{"target": "test"}', "-m", '{"grammar": "auto"}', "-o",
                str(tmp_path / str(len(errors))), *extra]
        assert fn(argv) == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "needs a target name" in errors[0]


@pytest.mark.parametrize("mutator,mopts,seed", [
    ("bit_flip", {}, None), ("afl", {"seed": 5}, SHORT)])
def test_mutator_states_resume_across_packages(mutator, mopts, seed,
                                               tmp_path):
    """-msd of one package resumes in the other through -msf and -ms:
    the continued campaigns write what the writer's own resume would."""
    seed = _seed_file(tmp_path, seed)
    first = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / f"first_{pkg}"
        d.mkdir()
        first[pkg], _ = _run(pkg, d, mutator, mopts, seed, "-n", "128",
                             "-fb", "0", "--no-stats")
    assert first["torch"] == first["jax"]
    state_file = tmp_path / "first_jax" / "jax.msd"
    runs = {}
    for pkg, resume in (("torch", ["-msf", str(state_file)]),
                        ("jax", ["-ms", first["torch"]["msd"]])):
        d = tmp_path / f"again_{pkg}"
        d.mkdir()
        runs[pkg], _ = _run(pkg, d, mutator, mopts, seed, "-n", "128",
                            "-fb", "0", "--no-stats", *resume)
    assert runs["torch"] == runs["jax"]
    assert json.loads(runs["torch"]["msd"])["iteration"] > 128
