"""The port's ``afl`` instrumentation against the JAX package's on the
corpus fixtures, with inputs made from a numpy seed: every single-exec
verdict (status, new path, unique crash/hang), every ``BatchResult``
field of batched runs (with the -3 padding sentinel), the three virgin
maps and the ``get_state`` strings, ``ignore_bytes_file``,
``modules``, ``edges`` and ``merge``; and the batch triage itself:
``device_triage`` 1 (torch ops, here on the CPU, across lane-chunk
boundaries) against the JAX package's ``_triage_host_bitmaps`` and
the numpy word-skip path.  Tolerance: none."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, MAP_SIZE
from killerbeez_tpu.instrumentation.afl import _triage_host_bitmaps
from killerbeez_tpu.instrumentation.factory import \
    instrumentation_factory as jax_instr
from killerbeez_tpu_torch.instrumentation.afl import triage_host_bitmaps
from killerbeez_tpu_torch.instrumentation.factory import \
    instrumentation_factory
from killerbeez_tpu_torch.ops.coverage import (
    has_new_bits_scan, has_new_bits_seq,
)
from killerbeez_tpu_torch.utils.serialization import encode_array

torch.set_num_threads(1)


def _pair(opts=None):
    o = json.dumps(opts or {})
    return jax_instr("afl", o), instrumentation_factory("afl", o,
                                                        device="cpu")


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    bufs = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    depth = rng.integers(0, 5, n)
    for i, d in enumerate(depth):
        bufs[i, :d] = np.frombuffer(b"ABCD"[:d], np.uint8)
    # in-batch duplicates on purpose: the second copy is no new path
    bufs[n // 2:n // 2 + 3] = bufs[:3]
    return bufs, np.full(n, 8, dtype=np.int32)


def _same_result(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _same_state(ref, got):
    assert got.get_state() == ref.get_state()
    for m in ("virgin_bits", "virgin_crash", "virgin_tmout"):
        np.testing.assert_array_equal(getattr(got, m), getattr(ref, m))


def test_single_exec_verdicts_match_jax(corpus_bin):
    ref, got = _pair({"edges": 1})
    bufs, _ = _inputs(24, seed=1)
    for b in list(bufs[:12]) + [b"ABCD", b"ABCDx"]:
        for i in (ref, got):
            i.enable(bytes(b), cmd_line=corpus_bin("test"))
        assert (got.get_fuzz_result(), got.is_new_path(),
                got.last_unique_crash(), got.last_unique_hang()) == \
            (ref.get_fuzz_result(), ref.is_new_path(),
             ref.last_unique_crash(), ref.last_unique_hang())
        assert got.get_edges() == ref.get_edges()
    assert got.get_fuzz_result() == FUZZ_CRASH
    assert got.last_unique_crash() is False       # the same crash path
    _same_state(ref, got)
    ref.cleanup()
    got.cleanup()


def test_hang_verdicts_match_jax(corpus_bin):
    """A hang's own map counts loop turns until the kill, which vary
    with timing, so only the verdicts are compared here."""
    ref, got = _pair({"timeout": 1.0})
    for i in (ref, got):
        i.enable(b"Hang", cmd_line=corpus_bin("hang"))
        assert (i.get_fuzz_result(), i.last_unique_hang()) == \
            (FUZZ_HANG, True)
        i.enable(b"okay", cmd_line=corpus_bin("hang"))
        assert i.get_fuzz_result() == 0 and not i.last_unique_hang()
    ref.cleanup()
    got.cleanup()


@pytest.mark.parametrize("device_triage", [0, 1])
def test_batched_runs_match_jax(corpus_bin, device_triage):
    ref, got = _pair({"device_triage": device_triage})
    for i in (ref, got):
        i.prepare_host(corpus_bin("test"), use_stdin=True)
    for seed, n, pad in ((2, 24, None), (3, 10, 16), (4, 16, None)):
        bufs, lens = _inputs(n, seed)
        r = ref.run_batch(bufs, lens, pad_to=pad)
        g = got.run_batch(bufs, lens, pad_to=pad)
        _same_result(r, g)
        assert isinstance(g.statuses, np.ndarray)
        np.testing.assert_array_equal(got.last_trace(), ref.last_trace())
        if pad:
            assert (g.statuses[n:] == FUZZ_ERROR).all()
            assert not g.new_paths[n:].any()
    assert got.total_execs == 50
    _same_state(ref, got)
    ref.cleanup()
    got.cleanup()


def test_ignore_bytes_file_matches_jax(corpus_bin, tmp_path):
    # mask every slot the seed's path touches: only deeper paths count
    probe, _ = _pair({"edges": 1})
    probe.enable(b"zzzz", cmd_line=corpus_bin("test"))
    mask = np.zeros(MAP_SIZE, dtype=np.uint8)
    mask[[s for s, _ in probe.get_edges()]] = 1
    probe.cleanup()
    path = tmp_path / "ignore.json"
    path.write_text(json.dumps({"ignore_bytes": encode_array(mask)}))
    ref, got = _pair({"ignore_bytes_file": str(path)})
    for i in (ref, got):
        i.prepare_host(corpus_bin("test"), use_stdin=True)
    bufs, lens = _inputs(20, seed=6)
    _same_result(ref.run_batch(bufs, lens), got.run_batch(bufs, lens))
    for b in (b"zzzz", b"Azzz"):
        for i in (ref, got):
            i.enable(b, cmd_line=corpus_bin("test"))
        assert got.is_new_path() == ref.is_new_path()
    _same_state(ref, got)
    ref.cleanup()
    got.cleanup()


def test_modules_and_merge_match_jax(corpus_bin):
    ref, got = _pair({"modules": 1, "edges": 1})
    for i in (ref, got):
        for data in (b"xx", b"yy", b"LZ"):
            i.enable(data, cmd_line=corpus_bin("libtest"))
    assert got.get_module_info() == ref.get_module_info()
    assert "libtest1.so" in got.get_module_info()
    assert got.module_coverage_bytes() == ref.module_coverage_bytes()
    assert got.module_map_ranges() == ref.module_map_ranges()
    for m in got.get_module_info():
        assert got.get_module_edges(m) == ref.get_module_edges(m)
    other_ref, other_got = _pair()
    for i in (other_ref, other_got):
        i.enable(b"ABzz", cmd_line=corpus_bin("test"))
    ref.merge(other_ref.get_state())
    got.merge(other_got.get_state())
    _same_state(ref, got)
    assert got.coverage_bytes() == ref.coverage_bytes()
    fresh = instrumentation_factory("afl", None, device="cpu")
    fresh.set_state(ref.get_state())
    _same_state(ref, fresh)
    for i in (ref, got, other_ref, other_got):
        i.cleanup()


def _random_maps(rng, n):
    maps = np.zeros((n, MAP_SIZE), np.uint8)
    idx = rng.integers(0, MAP_SIZE, (6, int(MAP_SIZE * 2e-3)))
    for i in range(n):  # duplicates within the batch on purpose
        maps[i, idx[i % 6]] = rng.integers(1, 255)
    maps[n // 3] = 0
    verd = rng.choice([0, FUZZ_CRASH, FUZZ_HANG, FUZZ_ERROR], n,
                      p=[0.6, 0.15, 0.15, 0.1]).astype(np.int32)
    return maps, verd


@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_device_triage_matches_jax_and_numpy(chunk):
    """40 lanes per batch over three batches carrying the maps: chunks
    of 16 split each batch twice, chunks of 1 judge lane by lane."""
    rng = np.random.default_rng(7)
    ff = np.full(MAP_SIZE, 0xFF, np.uint8)
    jmaps = [jnp.asarray(ff.copy()) for _ in range(3)]
    tmaps = [torch.from_numpy(ff.copy()) for _ in range(3)]
    host = instrumentation_factory("afl", None, device="cpu")
    for _ in range(3):
        maps, verd = _random_maps(rng, 40)
        j = _triage_host_bitmaps(jnp.asarray(maps), jnp.asarray(verd),
                                 *jmaps)
        jmaps = list(j[3:])
        t = triage_host_bitmaps(torch.from_numpy(maps),
                                torch.from_numpy(verd), *tmaps,
                                chunk=chunk)
        tmaps = list(t[3:])
        n = host._np_triage_batch(maps, verd)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(j[:3], n):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(j[0]).any() and np.asarray(j[1]).any()
    for m, name in zip(jmaps, ("virgin_bits", "virgin_crash",
                               "virgin_tmout")):
        np.testing.assert_array_equal(np.asarray(m),
                                      getattr(host, name))


def test_has_new_bits_scan_matches_the_sequential_loop():
    rng = np.random.default_rng(2)
    virgin = torch.from_numpy(rng.integers(0, 256, 256, dtype=np.uint8))
    traces = torch.from_numpy(
        (rng.random((33, 256)) < 0.05) * rng.integers(0, 256, (33, 256))
    ).to(torch.uint8)
    active = torch.ones(33, dtype=torch.bool)
    got = has_new_bits_scan(virgin, traces, active)
    ref = has_new_bits_seq(virgin, traces)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_qemu_mode_defaults_to_the_bundled_tracer():
    instr = instrumentation_factory("afl", json.dumps({"qemu_mode": 1}),
                                    device="cpu")
    assert instr.options["qemu_path"].endswith(
        "build/torch_native/kb-trace")
    with pytest.raises(ValueError, match="qemu"):
        instrumentation_factory("afl", json.dumps(
            {"qemu_mode": 1, "qemu_path": "/nonexistent"}), device="cpu")
