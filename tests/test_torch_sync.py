"""The port's manager-mediated corpus sync (killerbeez_tpu_torch/corpus/
sync.py), the counterpart of tests/test_corpus.py's sync cases on the
CPU, and the mixed fleet: a port worker and a JAX worker on one
campaign through the port's manager exchange corpus rows both ways, and
a manager DB written by the JAX manager is served by the port's with
the same jobs and corpus rows."""

import base64
import json
import urllib.request

import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.manager import ManagerServer as JaxServer
from killerbeez_tpu_torch.corpus import CorpusStore, CorpusSync
from killerbeez_tpu_torch.drivers.factory import driver_factory
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.factory import (
    instrumentation_factory,
)
from killerbeez_tpu_torch.manager import ManagerServer
from killerbeez_tpu_torch.mutators.factory import mutator_factory

torch.set_num_threads(1)

SEED = b"CG\x02\x04\x05\x41xx"


@pytest.fixture
def server():
    s = ManagerServer(port=0)
    s.start()
    yield s
    s.stop()


def _post(server, path, payload):
    url = f"http://127.0.0.1:{server.port}{path}"
    r = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return json.loads(resp.read())


def _make_fuzzer(tmp_path, corpus_dir=None, resume=False, seed_n=11,
                 feedback=2, sync=None):
    instr = instrumentation_factory(
        "jit_harness", '{"target": "cgc_like", "novelty": "throughput"}',
        device="cpu")
    mut = mutator_factory("havoc", json.dumps({"seed": seed_n}), SEED,
                          device="cpu")
    drv = driver_factory("file", None, instr, mut, device="cpu")
    fz = Fuzzer(drv, output_dir=str(tmp_path / "out"), batch_size=256,
                feedback=feedback, corpus_dir=corpus_dir, resume=resume,
                sync=sync)
    fz.PERSIST_INTERVAL = 0.0
    return fz


def test_corpus_endpoint_dedups_by_coverage_hash(server):
    def entry(worker, md5, content):
        return {"worker": worker, "md5": md5, "cov_hash": "sig:deadbeef",
                "content_b64": base64.b64encode(content).decode(),
                "meta": {"seq": 0}}

    code, r1 = _post(server, "/api/corpus/j1", entry("w1", "m1", b"A"))
    assert code == 201 and r1["new"] is True
    code, r2 = _post(server, "/api/corpus/j1", entry("w2", "m2", b"B"))
    assert code == 200 and r2["new"] is False
    assert r2["id"] == r1["id"]
    assert len(server.db.get_corpus_entries("j1", 0, "w2")) == 1
    assert len(server.db.get_corpus_entries("j1", 0, "w1")) == 0
    code, r3 = _post(server, "/api/corpus/j2", entry("w1", "m1", b"A"))
    assert r3["new"] is True


def test_two_worker_sync_exchanges_frontier(server, tmp_path):
    url = f"http://127.0.0.1:{server.port}"

    def worker(name, seed_n):
        sync = CorpusSync(url, "campX", worker=name, interval_s=0.0)
        return _make_fuzzer(tmp_path / name,
                            corpus_dir=str(tmp_path / name / "c"),
                            seed_n=seed_n, sync=sync)

    f1 = worker("w1", 11)
    f1.run(1024)
    assert f1.sync.pushed_n > 0
    f2 = worker("w2", 22)
    f2.run(1024)
    assert f2.sync.pulled_n > 0
    assert "sync" in [a.source for a in f2.scheduler.arms]
    stored = CorpusStore(str(tmp_path / "w2" / "c")).load()
    assert any(e.source == "sync" for e in stored)
    hashes = [r["cov_hash"]
              for r in server.db.get_corpus_entries("campX", 0)]
    assert len(hashes) == len(set(hashes))
    c = f2.telemetry.registry.counters
    assert c.get("corpus_synced_in", 0) == f2.sync.pulled_n
    assert c.get("corpus_synced_out", 0) == f2.sync.pushed_n


def test_resumed_worker_does_not_readmit_pulled_entries(server, tmp_path):
    url = f"http://127.0.0.1:{server.port}"
    f1 = _make_fuzzer(tmp_path / "w1", corpus_dir=str(tmp_path / "w1" / "c"),
                      sync=CorpusSync(url, "campR", worker="w1",
                                      interval_s=0.0))
    f1.run(1024)
    f2 = _make_fuzzer(tmp_path / "w2", corpus_dir=str(tmp_path / "w2" / "c"),
                      seed_n=22, sync=CorpusSync(url, "campR", worker="w2",
                                                 interval_s=0.0))
    f2.run(1024)
    assert f2.sync.pulled_n > 0
    arms_before = len(f2.scheduler.arms)
    f2b = _make_fuzzer(tmp_path / "w2", corpus_dir=str(tmp_path / "w2" / "c"),
                       seed_n=22, resume=True,
                       sync=CorpusSync(url, "campR", worker="w2",
                                       interval_s=1e9))
    assert len(f2b.scheduler.arms) == arms_before
    synced_in = f2b.telemetry.registry.counters["corpus_synced_in"]
    assert f2b.sync.maybe_sync(f2b, force=True)
    assert len(f2b.scheduler.arms) == arms_before
    assert f2b.sync.pulled_n == 0
    assert f2b.telemetry.registry.counters["corpus_synced_in"] == synced_in


def test_sync_survives_dead_manager(tmp_path, monkeypatch):
    import killerbeez_tpu_torch.manager.worker as w
    calls = {"n": 0}
    orig = w._request_retry

    def counting(url, payload=None, method="POST", **kw):
        calls["n"] += 1
        return orig(url, payload, method, **kw)

    monkeypatch.setattr(w, "_request_retry", counting)
    sync = CorpusSync("http://127.0.0.1:1", "c", worker="w",
                      interval_s=0.0, attempts=1)
    fz = _make_fuzzer(tmp_path, sync=sync)
    stats = fz.run(512)
    assert stats.iterations == 512
    assert sync.pushed_n == 0 and sync.pulled_n == 0
    assert len(sync._pending) == len(fz.scheduler.arms) > 0
    assert calls["n"] <= 2 * (512 // 256 + 1)


def test_sync_counters_survive_resume(tmp_path):
    sync = CorpusSync("http://127.0.0.1:1", "c", worker="w",
                      interval_s=1e9, attempts=1)
    fz = _make_fuzzer(tmp_path, sync=sync)
    fz.telemetry.registry.counters["corpus_synced_in"] = 100.0
    assert sync.maybe_sync(fz, force=True)
    assert fz.telemetry.registry.counters["corpus_synced_in"] == 100.0


def test_cli_sync_flag_checks(tmp_path, capsys):
    (tmp_path / "seed").write_bytes(SEED)
    base = ["file", "jit_harness", "havoc", "-sf", str(tmp_path / "seed"),
            "-i", '{"target": "cgc_like"}', "-o", str(tmp_path / "o"),
            "--device", "cpu"]
    assert main(base + ["--gossip"]) == 2
    assert "--gossip needs --sync-manager" in capsys.readouterr().err
    assert main(base + ["--sync-manager", "http://127.0.0.1:1"]) == 2
    assert "--sync-manager needs --sync-campaign" in \
        capsys.readouterr().err


# ---------------------------------------------------------------------------
# the mixed fleet
# ---------------------------------------------------------------------------


def _cli_argv(tmp_path, name, url, seed_n, extra=()):
    return ["file", "jit_harness", "havoc", "-sf", str(tmp_path / "seed"),
            "-i", '{"target": "cgc_like", "novelty": "throughput"}', "-m",
            json.dumps({"seed": seed_n}), "-b", "256", "-n", "2048",
            "-o", str(tmp_path / name), "--corpus-dir",
            str(tmp_path / name / "corpus"), "--no-stats",
            "--sync-manager", url, "--sync-campaign", "mixed",
            "--sync-worker", name, "--sync-interval", "0", *extra]


def _synced_in(tmp_path, name):
    return [e for e in CorpusStore(str(tmp_path / name / "corpus")).load()
            if e.source == "sync"]


def test_mixed_fleet_exchanges_rows_both_ways(server, tmp_path):
    """A port worker, then a JAX worker, then a second port worker on one
    campaign through the port's manager: the JAX worker admits the port
    worker's rows, the second port worker the JAX worker's."""
    (tmp_path / "seed").write_bytes(SEED)
    url = f"http://127.0.0.1:{server.port}"
    assert main(_cli_argv(tmp_path, "port1", url, 11,
                          ["--device", "cpu"])) == 0
    assert jax_main(_cli_argv(tmp_path, "jax1", url, 22)) == 0
    assert main(_cli_argv(tmp_path, "port2", url, 33,
                          ["--device", "cpu"])) == 0
    rows = server.db.get_corpus_entries("mixed", 0)
    by = {}
    for r in rows:
        by.setdefault(r["worker"], set()).add(r["md5"])
    assert {"port1", "jax1"} <= set(by)
    jax_in = {e.md5 for e in _synced_in(tmp_path, "jax1")}
    port_in = {e.md5 for e in _synced_in(tmp_path, "port2")}
    assert jax_in & by["port1"], "the JAX worker took no port row"
    assert port_in & by["jax1"], "the port worker took no JAX row"


def test_port_manager_serves_a_jax_manager_db(tmp_path):
    db = str(tmp_path / "m.db")
    j = JaxServer(port=0, db_path=db)
    j.start()
    try:
        _, t = _post(j, "/api/target", {"name": "tgt"})
        _, job = _post(j, "/api/job", {
            "target_id": t["id"], "driver": "file",
            "instrumentation": "jit_harness", "mutator": "havoc",
            "iterations": 64, "seed_file": "s.bin",
            "instrumentation_opts": '{"target": "test"}'})
        _post(j, "/api/corpus/7", {
            "worker": "w1", "md5": "m1", "cov_hash": "sig:1",
            "content_b64": base64.b64encode(b"ABCD").decode(),
            "meta": {"seq": 0}})
        jobs = _get(j.port, "/api/job")
        corpus = _get(j.port, "/api/corpus/7?since=0")
    finally:
        j.stop()
    p = ManagerServer(port=0, db_path=db)
    p.start()
    try:
        assert _get(p.port, "/api/job") == jobs
        assert _get(p.port, f"/api/job/{job['id']}")["instrumentation"] \
            == "jit_harness"
        assert _get(p.port, "/api/corpus/7?since=0") == corpus
    finally:
        p.stop()
