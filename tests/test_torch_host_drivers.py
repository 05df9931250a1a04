"""The port's host-executed drivers and instrumentations against the JAX
package's on the corpus fixtures: ``stdin`` and ``file`` (``@@``,
``test_filename``, single exec and batched), ``packet`` batching with
the ``manager`` mutator, ``network_server`` over TCP and UDP,
``network_client``, ``return_code``, ``debug`` (equal
``crash_description()`` text) and ``ipt`` in ``qemu_mode`` (gated by
the ``kb_trace_usable`` probe): the same verdicts, novelty flags,
findings and state strings.  The network tests bind ports the kernel
hands out (port 0), never a fixed range.  Also the mutators'
``prefetch_batch``: the same candidates with and without it, and a
stash dropped by a seed swap.  Tolerance: none."""

import json
import os
import socket

import numpy as np
import pytest
import torch

from killerbeez_tpu.drivers.factory import driver_factory as jax_driver
from killerbeez_tpu.drivers.network_server import \
    is_port_listening as jax_listening
from killerbeez_tpu.fuzzer.loop import Fuzzer as JaxFuzzer
from killerbeez_tpu.instrumentation.factory import \
    instrumentation_factory as jax_instr
from killerbeez_tpu.mutators.factory import mutator_factory as jax_mutator
from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.drivers.network_server import is_port_listening
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.factory import \
    instrumentation_factory
from killerbeez_tpu_torch.mutators.factory import mutator_factory
from killerbeez_tpu_torch.utils.serialization import encode_mem_array

torch.set_num_threads(1)


def _free_port(udp=False):
    s = socket.socket(socket.AF_INET,
                      socket.SOCK_DGRAM if udp else socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def seq(*parts: bytes) -> bytes:
    return encode_mem_array(list(parts)).encode()


def _stack(pkg, driver, dopts, instr, iopts=None, mutator=None,
           mopts=None, seed=b"ABC@"):
    """(driver, instrumentation, mutator) of one package."""
    i_opts = json.dumps(iopts) if iopts else None
    m_opts = json.dumps(mopts) if mopts else None
    if pkg == "jax":
        ins = jax_instr(instr, i_opts)
        mut = jax_mutator(mutator, m_opts, seed) if mutator else None
        return jax_driver(driver, json.dumps(dopts), ins, mut), ins, mut
    ins = instrumentation_factory(instr, i_opts, device="cpu")
    mut = mutator_factory(mutator, m_opts, seed, device="cpu") \
        if mutator else None
    return (driver_factory(driver, json.dumps(dopts), ins, mut,
                           device="cpu"), ins, mut)


def _close(*parts):
    for p in parts:
        if p is not None:
            p.cleanup()


def _verdicts(drv, ins, inputs):
    out = []
    for b in inputs:
        out.append((drv.test_input(b), ins.is_new_path(),
                    ins.last_unique_crash(), ins.last_unique_hang(),
                    drv.get_last_input()))
    return out


def _each_package(make, inputs):
    """Run ``inputs`` through each package's stack from ``make(pkg)``;
    returns the port's (verdicts, state) after asserting the JAX
    package's are equal."""
    got = {}
    for pkg in ("jax", "torch"):
        drv, ins, mut = make(pkg)
        got[pkg] = (_verdicts(drv, ins, inputs), ins.get_state())
        _close(drv, ins, mut)
    assert got["torch"] == got["jax"]
    return got["torch"]


@pytest.mark.parametrize("driver", ["stdin", "file"])
@pytest.mark.parametrize("instr", ["afl", "return_code"])
def test_single_exec_drivers_match_jax(corpus_bin, driver, instr):
    dopts = {"path": corpus_bin("test")}
    if driver == "file":
        dopts["arguments"] = "@@"
    verdicts, _ = _each_package(
        lambda pkg: _stack(pkg, driver, dopts, instr),
        [b"zzzz", b"Azzz", b"ABCD", b"ABzz", b"ABCD", b"zzzz"])
    assert [v[0] for v in verdicts].count(FUZZ_CRASH) == 2


def test_file_driver_test_filename_and_cleanup(corpus_bin, tmp_path):
    path = tmp_path / "input.bin"
    drv, ins, _ = _stack("torch", "file", {
        "path": corpus_bin("test"), "arguments": "@@",
        "test_filename": str(path)}, "afl")
    assert drv.test_input(b"ABCD") == FUZZ_CRASH
    assert path.read_bytes() == b"ABCD"
    drv.cleanup()                 # a given file name is the user's
    assert path.exists()
    tmp_drv, tmp_ins, _ = _stack("torch", "file", {
        "path": corpus_bin("test")}, "afl")
    assert tmp_drv.test_input(b"zzzz") == FUZZ_NONE
    temp = tmp_drv.test_filename
    assert os.path.exists(temp)
    tmp_drv.cleanup()             # a temp file goes with the driver
    assert not os.path.exists(temp)
    _close(ins, tmp_ins)


@pytest.mark.parametrize("driver", ["stdin", "file"])
def test_batched_host_drivers_match_jax(corpus_bin, driver, tmp_path):
    """A havoc campaign through the batched host path (80 lanes in
    batches of 32: a padded tail), with the next batch prefetched."""
    dopts = {"path": corpus_bin("test")}
    got = {}
    for pkg, cls in (("jax", JaxFuzzer), ("torch", Fuzzer)):
        drv, ins, mut = _stack(pkg, driver, dopts, "afl", mutator="havoc",
                               mopts={"seed": 4}, seed=b"ABzz")
        assert drv.supports_batch
        fz = cls(drv, output_dir=str(tmp_path / pkg), batch_size=32,
                 feedback=0)
        fz.PIPELINE_DEPTH = 1
        stats = fz.run(80)
        got[pkg] = ({d: sorted(os.listdir(tmp_path / pkg / d))
                     for d in ("crashes", "hangs", "new_paths")},
                    ins.get_state(), mut.get_state(), stats.iterations)
        _close(drv, ins, mut)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["new_paths"]


def _server(pkg, corpus_bin, udp=False, instr="afl", mutator=None,
            mopts=None, seed=b"x"):
    port = _free_port(udp)
    return _stack(pkg, "network_server", {
        "path": corpus_bin("network_server"),
        "arguments": f"{port} udp" if udp else str(port),
        "port": port, "udp": int(udp), "timeout": 1.0}, instr,
        mutator=mutator, mopts=mopts, seed=seed)


@pytest.mark.parametrize("udp", [False, True])
def test_network_server_matches_jax(corpus_bin, udp):
    inputs = [seq(b"xxxx"), seq(b"xxxx"), seq(b"HELO", b"yyyy")]
    if not udp:
        inputs += [seq(b"HELO", b"BOOM"), seq(b"HELO", b"nope"),
                   b"raw bytes are one packet"]
    verdicts, _ = _each_package(
        lambda pkg: _server(pkg, corpus_bin, udp=udp), inputs)
    assert verdicts[0][1] > 0 and verdicts[1][1] == 0
    if not udp:
        assert verdicts[3][0] == FUZZ_CRASH and verdicts[3][2]


def test_network_server_return_code_matches_jax(corpus_bin):
    verdicts, _ = _each_package(
        lambda pkg: _server(pkg, corpus_bin, instr="return_code"),
        [seq(b"HELO", b"BOOM"), seq(b"HELO", b"okay")])
    assert [v[0] for v in verdicts] == [FUZZ_CRASH, FUZZ_NONE]


def test_network_client_matches_jax(corpus_bin):
    def make(pkg):
        port = _free_port()
        return _stack(pkg, "network_client", {
            "path": corpus_bin("network_client"), "arguments": str(port),
            "port": port, "timeout": 1.0}, "afl")
    verdicts, _ = _each_package(make, [b"KILL", b"okay", b"KILL"])
    assert [v[0] for v in verdicts] == [FUZZ_CRASH, FUZZ_NONE, FUZZ_CRASH]


def test_packet_driver_batches_the_manager_mutator(corpus_bin, tmp_path):
    """The manager's candidates are made a batch at a time and
    delivered one connection each: part 2 "BOOL" is one bit from the
    crasher "BOOM", so the bit_flip child finds it."""
    got = {}
    for pkg, cls in (("jax", JaxFuzzer), ("torch", Fuzzer)):
        drv, ins, mut = _server(
            pkg, corpus_bin, mutator="manager",
            mopts={"mutators": ["nop", "bit_flip"]},
            seed=seq(b"HELO", b"BOOL"))
        assert drv.supports_batch and drv.num_inputs == 2
        fz = cls(drv, output_dir=str(tmp_path / pkg), batch_size=16,
                 feedback=0)
        fz.PIPELINE_DEPTH = 1
        fz.run(64)
        got[pkg] = ({d: sorted(os.listdir(tmp_path / pkg / d))
                     for d in ("crashes", "hangs", "new_paths")},
                    ins.get_state(), drv.get_last_input())
        _close(drv, ins, mut)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["crashes"]


def test_is_port_listening_matches_jax():
    for udp in (False, True):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM if udp
                          else socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        if not udp:
            s.listen(1)
        port = s.getsockname()[1]
        assert is_port_listening(port, udp) == jax_listening(port, udp) \
            is True
        s.close()


def test_return_code_hang_matches_jax(corpus_bin):
    def make(pkg):
        return _stack(pkg, "stdin", {"path": corpus_bin("hang")},
                      "return_code", iopts={"timeout": 1.0})
    verdicts, _ = _each_package(make, [b"Hang", b"okay"])
    assert [v[0] for v in verdicts] == [FUZZ_HANG, FUZZ_NONE]


def test_debug_crash_description_matches_jax(corpus_bin):
    descs = {}
    for pkg in ("jax", "torch"):
        drv, ins, _ = _stack(pkg, "stdin", {"path": corpus_bin("crashers")},
                             "debug")
        descs[pkg] = []
        # (SIGABRT is left out: its si_addr slot holds the pid)
        for b in (b"TRAP", b"LIBC", b"LIBC", b"zzzz"):
            v = drv.test_input(b)
            descs[pkg].append((v, ins.last_unique_crash(),
                               ins.crash_description()))
        descs[pkg].append(ins.get_state())
        _close(drv, ins)
    assert descs["torch"] == descs["jax"]
    assert descs["torch"][0][2].startswith("SIGTRAP at pc=")


def test_ipt_qemu_mode_matches_jax(corpus_bin, kb_trace_usable):
    """Hash coverage of an uninstrumented binary under kb-trace: single
    execs, then a batch padded to 8 result lanes."""
    tgt = corpus_bin("test-plain")
    got = {}
    for pkg in ("jax", "torch"):
        ins = jax_instr("ipt", '{"qemu_mode": 1}') if pkg == "jax" else \
            instrumentation_factory("ipt", '{"qemu_mode": 1}',
                                    device="cpu")
        rows = []
        for b in (b"zzzz", b"zzzz", b"ABCD", b"ABCD", b"ABXD"):
            ins.enable(b, cmd_line=tgt)
            rows.append((ins.get_fuzz_result(), ins.is_new_path(),
                         ins.last_unique_crash()))
        ins.prepare_host(tgt, use_stdin=True)
        inputs = np.zeros((5, 4), np.uint8)
        for i, s in enumerate([b"zzzz", b"ABXD", b"AXCD", b"AXCD",
                               b"ABCD"]):
            inputs[i] = np.frombuffer(s, np.uint8)
        res = ins.run_batch(inputs, np.full(5, 4, np.int32), pad_to=8)
        rows.append([np.asarray(a).tolist() for a in res])
        rows.append(ins.get_state())
        got[pkg] = rows
        ins.cleanup()
    assert got["torch"] == got["jax"]
    assert got["torch"][5][1] == [0, 0, 1, 0, 0, 0, 0, 0]
    assert json.loads(got["torch"][6])["hash_scheme"] == "host-block"


# -- prefetch_batch ----------------------------------------------------------

@pytest.mark.parametrize("name,opts", [
    ("havoc", {"seed": 2}), ("bit_flip", None), ("afl", {"seed": 2}),
    ("honggfuzz", {"seed": 2}),
])
def test_prefetch_gives_the_same_candidates(name, opts):
    seed = b"ABCDEFGHIJ"
    o = json.dumps(opts) if opts else None
    plain = mutator_factory(name, o, seed, device="cpu")
    pre = mutator_factory(name, o, seed, device="cpu")
    assert pre.lazy_batches
    for n, nxt in ((16, 16), (16, 5), (5, 0)):
        a = plain.mutate_batch_host(n)
        b = pre.mutate_batch_host(n)
        if nxt:
            pre.prefetch_batch(nxt)
            assert pre._stash is not None and pre._stash[1] == nxt
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert plain.iteration == pre.iteration == 37
    # the stash also serves mutate_batch (device tensors)
    pre.prefetch_batch(8)
    bufs, lens = pre.mutate_batch(8)
    ref = plain.mutate_batch(8)
    assert torch.equal(bufs, ref[0]) and torch.equal(lens, ref[1])


def test_prefetch_stash_is_dropped_by_a_seed_swap():
    mut = mutator_factory("havoc", '{"seed": 1}', b"ABCDEFGH",
                          device="cpu")
    ref = mutator_factory("havoc", '{"seed": 1}', b"ABCDEFGH",
                          device="cpu")
    mut.prefetch_batch(8)
    mut.set_input(b"zzzzzzzz", keep_length=True)
    ref.set_input(b"zzzzzzzz", keep_length=True)
    assert mut._stash is None
    for x, y in zip(mut.mutate_batch_host(8), ref.mutate_batch_host(8)):
        np.testing.assert_array_equal(x, y)
    # a stash for another start or size is stale and regenerated
    mut.prefetch_batch(8)
    mut.iteration += 1
    ref.iteration += 1
    for x, y in zip(mut.mutate_batch_host(8), ref.mutate_batch_host(8)):
        np.testing.assert_array_equal(x, y)
    # a rejected swap keeps the seed, and so its stash
    mut.prefetch_batch(4)
    with pytest.raises(ValueError):
        mut.set_input(b"x" * 64, keep_length=True)
    assert mut._stash is not None
