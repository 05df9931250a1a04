"""The port's native exec backend (``killerbeez_tpu_torch/native``,
built into ``build/torch_native/``) against the JAX package's (built
into ``native/build/``), on the corpus fixture binaries: the status
encoding, and ``ExecTarget.run_batch``'s raw statuses and 64 KB
bitmaps byte for byte in every exec mode (forkserver, fork+exec,
persistent, deferred, LD_PRELOAD forkserver, file delivery), and an
``ExecPool`` against one instance.  Inputs are made from a numpy
seed.  Tolerance: none."""

import os

import numpy as np
import pytest

from killerbeez_tpu.native import exec_backend as jax_eb
from killerbeez_tpu_torch.native import build
from killerbeez_tpu_torch.native import exec_backend as eb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(n=24, seed=11):
    """Prefixes of the crasher's magic with random tails: every depth
    of ``test``'s branches, one crash per ``ABCD`` lane."""
    rng = np.random.default_rng(seed)
    bufs = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    depth = rng.integers(0, 5, n)
    for i, d in enumerate(depth):
        bufs[i, :d] = np.frombuffer(b"ABCD"[:d], np.uint8)
    lens = rng.integers(1, 17, n).astype(np.int32)
    lens[depth == 4] = np.maximum(lens[depth == 4], 4)
    return bufs, lens


def test_classify_matches_jax():
    rng = np.random.default_rng(3)
    raw = np.concatenate([np.arange(-3, 260), rng.integers(
        -3, 600, 500)]).astype(np.int32)
    for s in raw[:300]:
        assert eb.classify(int(s)) == jax_eb.classify(int(s))
    for a, b in zip(eb.classify_batch(raw), jax_eb.classify_batch(raw)):
        np.testing.assert_array_equal(a, b)


MODES = {
    "forkserver": ("test", dict(use_forkserver=True)),
    "fork_exec": ("test", dict(use_forkserver=False)),
    "persistent": ("test-persist", dict(use_forkserver=True,
                                        persistent=4)),
    "deferred": ("test-deferred", dict(use_forkserver=True,
                                       deferred=True)),
    "preload": ("test-plain", dict(use_preload_forkserver=True)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_batch_matches_jax(corpus_bin, mode):
    name, kw = MODES[mode]
    bufs, lens = _inputs()
    got = {}
    for pkg, mod in (("jax", jax_eb), ("torch", eb)):
        with mod.ExecTarget([corpus_bin(name)], use_stdin=True,
                            coverage=True, timeout=2.0, **kw) as t:
            got[pkg] = t.run_batch(bufs, lens)
    st, maps = got["torch"]
    np.testing.assert_array_equal(st, got["jax"][0])
    np.testing.assert_array_equal(maps, got["jax"][1])
    crash = np.array([bytes(b[:4]) == b"ABCD" and n >= 4
                      for b, n in zip(bufs, lens)])
    np.testing.assert_array_equal(st >= 512, crash)
    if mode != "preload":               # test-plain has no coverage
        assert maps.any(axis=1).all()


def test_file_delivery_matches_jax(corpus_bin, tmp_path):
    bufs, lens = _inputs(12, seed=5)
    got = {}
    for pkg, mod in (("jax", jax_eb), ("torch", eb)):
        f = str(tmp_path / f"{pkg}.in")
        with mod.ExecTarget([corpus_bin("test"), f], input_file=f,
                            use_forkserver=True, coverage=True) as t:
            got[pkg] = t.run_batch(bufs, lens)
    for a, b in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(a, b)


def test_exec_pool_matches_a_single_instance(corpus_bin):
    bufs, lens = _inputs(30, seed=9)
    with eb.ExecTarget([corpus_bin("test")], use_stdin=True,
                       use_forkserver=True, coverage=True) as t:
        one = t.run_batch(bufs, lens)
    with eb.ExecPool([corpus_bin("test")], 4, use_stdin=True,
                     use_forkserver=True, coverage=True) as pool:
        many = pool.run_batch(bufs, lens)
        assert pool.total_execs() == 30
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)


def test_hang_and_single_exec_match_jax(corpus_bin):
    got = {}
    for pkg, mod in (("jax", jax_eb), ("torch", eb)):
        with mod.ExecTarget([corpus_bin("hang")], use_stdin=True,
                            use_forkserver=True, coverage=True,
                            timeout=1.0) as t:
            # the hang's own map counts loop turns, which vary with
            # timing: compare the next exec's map after a clear
            hang = t.run(b"Hang")
            t.clear_trace()
            got[pkg] = [hang, t.run(b"okay"), t.trace_bits().copy()]
    assert eb.classify(got["torch"][0])[0] == eb.FUZZ_HANG
    assert got["torch"][:2] == got["jax"][:2]
    np.testing.assert_array_equal(got["torch"][2], got["jax"][2])


def test_build_lands_in_its_own_directory(monkeypatch):
    """The port builds ``native/`` with an absolute ``BUILD`` under
    ``build/torch_native/`` and the corpus fixtures with an absolute
    ``BUILD`` below it: never into ``native/build/`` or
    ``corpus/build/``, which the JAX package builds."""
    assert build.BUILD_DIR == os.path.join(REPO, "build", "torch_native")
    calls = []
    monkeypatch.setattr(build, "_make", calls.append)
    monkeypatch.setattr(build, "_native_built", False)
    monkeypatch.setattr(build, "_corpus_built", set())
    build.build_corpus(["test"])
    assert calls[0] == ["-C", build.NATIVE_DIR, f"BUILD={build.BUILD_DIR}"]
    assert f"BUILD={build.CORPUS_BUILD_DIR}" in calls[1]
    assert f"KB_CC={build.BUILD_DIR}/kb-cc" in calls[1]
    assert os.path.join(build.CORPUS_BUILD_DIR, "test") in calls[1]
    for path in (eb.exec_lib_path(), build.kb_trace_path(),
                 build.corpus_path("test")):
        assert path.startswith(build.BUILD_DIR + os.sep)
        assert not path.startswith(os.path.join(REPO, "native"))


def test_port_builds_and_runs_its_own_fixture():
    """The port's own build of ``native/`` and ``corpus/test`` runs:
    the backend it loads is the one under build/torch_native/."""
    path = build.corpus_path("test")
    with eb.ExecTarget([path], use_stdin=True, use_forkserver=True,
                       coverage=True) as t:
        assert eb.classify(t.run(b"ABCD"))[0] == eb.FUZZ_CRASH
        assert eb.classify(t.run(b"ABzz"))[0] == eb.FUZZ_NONE
    assert eb._lib._name == os.path.join(build.BUILD_DIR, "libkbexec.so")
