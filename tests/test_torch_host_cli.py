"""The port's CLI against the JAX package's on host-executed targets
(the corpus fixture ``test``: "ABCD" crashes, each matched prefix byte
takes a new branch), both run in this process on the same binaries:
the same md5 sets under crashes/, hangs/ and new_paths/ (``-dt``'s
``.info`` files included, with equal text), the same ``-isd`` state
strings and ``fuzzer_stats`` counters, and under corpus feedback the
same ``scheduler_pick`` sequences, at ``Fuzzer.PIPELINE_DEPTH = 1`` on
both packages (tests/test_torch_feedback.py says why the depth is
pinned).  Tolerance: none."""

import json
import os

import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer

torch.set_num_threads(1)

COUNTERS = ("execs_done", "paths_total", "unique_crashes", "unique_hangs")


def _run(pkg, out, args):
    # "CORPUS" stands for this package's own corpus store
    argv = [str(out / "corpus") if a == "CORPUS" else a for a in args]
    argv += ["-o", str(out), "-isd", f"{out}.isd"]
    if pkg == "torch":
        argv += ["--device", "cpu"]
    assert (jax_main if pkg == "jax" else main)(argv) == 0
    got = {"findings": {d: sorted(os.listdir(out / d))
                        for d in ("crashes", "hangs", "new_paths")},
           "isd": open(f"{out}.isd").read(), "counters": {},
           "info": {}}
    for name in got["findings"]["crashes"]:
        if name.endswith(".info"):
            got["info"][name] = (out / "crashes" / name).read_text()
    with open(out / "fuzzer_stats") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k.strip() in COUNTERS:
                got["counters"][k.strip()] = v.strip()
    with open(out / "events.jsonl") as f:
        got["picks"] = [(e["arm"], e["rotation"])
                        for e in map(json.loads, f)
                        if e["type"] == "scheduler_pick"]
    corpus = out / "corpus"
    if corpus.is_dir():
        got["sigs"] = {}
        for name in os.listdir(corpus):
            if name.endswith(".json") and len(name) == 37:
                with open(corpus / name) as f:
                    got["sigs"][name] = json.load(f).get("sig")
    return got


def _both(tmp_path, args, monkeypatch):
    for cls in (JaxFuzzer, Fuzzer):
        monkeypatch.setattr(cls, "PIPELINE_DEPTH", 1)
    runs = {pkg: _run(pkg, tmp_path / pkg, args)
            for pkg in ("jax", "torch")}
    assert runs["torch"] == runs["jax"]
    return runs["torch"]


def test_file_return_code_bit_flip(corpus_bin, tmp_path, monkeypatch):
    """The reference's smoke config 1: bit_flip's whole 32-flip walk of
    'ABC@' in the single-exec loop (flip 29 makes 'ABCD')."""
    got = _both(tmp_path, [
        "file", "return_code", "bit_flip", "-n", "32", "-ss", "ABC@",
        "-d", json.dumps({"path": corpus_bin("test")})], monkeypatch)
    assert len(got["findings"]["crashes"]) == 1
    assert got["counters"]["execs_done"] == "32"


def test_stdin_afl_honggfuzz(corpus_bin, tmp_path, monkeypatch):
    """The reference's smoke config 2: exactly two new paths (the seed's
    one-byte prefix and the no-match path), with corpus feedback
    rotating after 8 of the 10 batches."""
    got = _both(tmp_path, [
        "stdin", "afl", "honggfuzz", "-n", "640", "-b", "64", "-ss",
        "Azzz", "-m", '{"seed": 3}',
        "-d", json.dumps({"path": corpus_bin("test")})], monkeypatch)
    assert got["counters"]["paths_total"] == "2"
    assert len(got["findings"]["new_paths"]) == 2
    assert [r for _, r in got["picks"]] == [1]


@pytest.mark.parametrize("device_triage", [0, 1])
def test_stdin_afl_bit_flip_tail_batch(corpus_bin, tmp_path, monkeypatch,
                                       device_triage):
    """A 10-byte seed's 80 flips at -b 64: a full batch, then a
    16-lane tail padded to 64 result lanes; both triage paths."""
    got = _both(tmp_path, [
        "stdin", "afl", "bit_flip", "-ss", "ABC@zzzzzz", "-b", "64",
        "-d", json.dumps({"path": corpus_bin("test")}),
        "-i", json.dumps({"device_triage": device_triage})], monkeypatch)
    assert got["counters"]["execs_done"] == "80"
    assert json.loads(got["isd"])["total_execs"] == 80
    assert len(got["findings"]["crashes"]) == 1


def test_debug_triage_info_files(corpus_bin, tmp_path, monkeypatch):
    got = _both(tmp_path, [
        "stdin", "afl", "bit_flip", "-ss", "ABC@", "-dt",
        "-d", json.dumps({"path": corpus_bin("test")})], monkeypatch)
    assert len(got["info"]) == 1
    assert next(iter(got["info"].values())).startswith("SIGSEGV at pc=")


def test_rare_edge_schedule_signs_on_the_live_target(corpus_bin, tmp_path,
                                                     monkeypatch):
    """Each admission is signed by one extra exec on the live target:
    the sidecars' ``sig`` lists, the picks and the state (its
    ``total_execs`` counts the signing execs) agree."""
    got = _both(tmp_path, [
        "stdin", "afl", "honggfuzz", "-n", "640", "-b", "64", "-ss",
        "ABzz", "-m", '{"seed": 5}', "--schedule", "rare-edge",
        "--corpus-dir", "CORPUS",
        "-d", json.dumps({"path": corpus_bin("test")})], monkeypatch)
    assert got["sigs"] and all(got["sigs"].values())
    assert got["picks"]


def test_host_campaign_asks_for_the_card(corpus_bin, tmp_path, capsys,
                                         monkeypatch):
    """Without --device the mutator (and afl's device triage) run on the
    card: with none, the CLI exits 2 and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["stdin", "afl", "honggfuzz", "-ss", "Azzz", "-n", "64",
            "-d", json.dumps({"path": corpus_bin("test")}),
            "-i", '{"device_triage": 1}', "-o", str(tmp_path)]
    assert main(argv) == 2
    assert "no CUDA card" in capsys.readouterr().err
    assert not (tmp_path / "new_paths").exists()
