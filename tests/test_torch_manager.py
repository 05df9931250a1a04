"""The port's manager tier (killerbeez_tpu_torch/manager/), the
counterpart of tests/test_manager.py on the CPU: DB, REST API, work
queue, worker +
assimilator) — reference SURVEY §2.8/§3.5 lifecycle: job create with
config resolution -> reproducible cmdline -> worker claim -> fuzz ->
assimilate findings -> results query; plus the minimize endpoint
(greedy edge cover over tracer_info, reference minimizer_test parity)
and stale-claim requeue (BOINC workunit retry semantics).
"""

import base64
import json
import urllib.request

import pytest

from killerbeez_tpu_torch.manager import ManagerDB, ManagerServer, format_cmdline
from killerbeez_tpu_torch.manager.worker import work_loop


@pytest.fixture
def server():
    s = ManagerServer(port=0)  # ephemeral port
    s.start()
    yield s
    s.stop()


def req(server, path, payload=None, method=None):
    url = f"http://127.0.0.1:{server.port}{path}"
    method = method or ("POST" if payload is not None else "GET")
    data = json.dumps(payload).encode() if payload is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type":
                                        "application/json"})
    with urllib.request.urlopen(r, timeout=10) as resp:
        body = resp.read()
        if resp.status == 204 or not body:
            return resp.status, None
        return resp.status, json.loads(body)


def test_db_config_resolution_per_target_beats_global():
    db = ManagerDB()
    tid = db.create_target("t1")
    db.set_config("mutator_opts_bit_flip", '{"num_bits": 1}')
    db.set_config("mutator_opts_bit_flip", '{"num_bits": 4}', tid)
    jid = db.create_job(tid, "file", "afl", "bit_flip")
    assert db.get_job(jid)["mutator_opts"] == '{"num_bits": 4}'
    db2_tid = db.create_target("t2")
    jid2 = db.create_job(db2_tid, "file", "afl", "bit_flip")
    assert db.get_job(jid2)["mutator_opts"] == '{"num_bits": 1}'


def test_format_cmdline_sh_escaping():
    job = {"driver": "file", "instrumentation": "afl",
           "mutator": "bit_flip", "iterations": 50,
           "seed_file": "seed with space.bin",
           "driver_opts": '{"path": "t"}'}
    cmd = format_cmdline(job)
    assert cmd.startswith("python -m killerbeez_tpu_torch.fuzzer "
                          "file afl bit_flip")
    assert "'seed with space.bin'" in cmd
    assert "-n 50" in cmd
    assert "'{\"path\": \"t\"}'" in cmd


def test_rest_target_config_job_roundtrip(server):
    code, t = req(server, "/api/target", {"name": "tgt"})
    assert code == 201
    code, _ = req(server, "/api/config",
                  {"name": "driver_opts_file",
                   "value": '{"path": "x"}', "target_id": t["id"]})
    assert code == 201
    code, job = req(server, "/api/job",
                    {"target_id": t["id"], "driver": "file",
                     "instrumentation": "afl", "mutator": "havoc",
                     "iterations": 10, "seed_file": "s.bin"})
    assert code == 201 and "cmdline" in job
    code, full = req(server, f"/api/job/{job['id']}")
    assert code == 200
    assert full["driver_opts"] == '{"path": "x"}'  # config resolved
    code, jobs = req(server, "/api/job?status=pending")
    assert code == 200 and len(jobs) == 1


def test_rest_file_roundtrip(server):
    payload = b"\x00\x01repro"
    code, f = req(server, "/api/file",
                  {"name": "r", "content_b64":
                   base64.b64encode(payload).decode()})
    assert code == 201
    url = f"http://127.0.0.1:{server.port}/api/file/{f['id']}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.read() == payload


def test_rest_minimize_greedy_cover(server):
    code, t = req(server, "/api/target", {"name": "tgt"})
    for name, edges in (("a", [1, 2, 3]), ("b", [2]), ("c", [9])):
        code, _ = req(server, "/api/tracer_info",
                      {"target_id": t["id"], "input_file": name,
                       "edges": edges})
        assert code == 201
    code, out = req(server, "/api/minimize", {"target_id": t["id"]})
    assert code == 200
    assert set(out["working_set"]) == {"a", "c"}  # b ⊂ a dropped


def test_work_claim_empty_queue_is_204(server):
    code, body = req(server, "/api/work/claim", {"worker": "w"})
    assert code == 204 and body is None


def test_requeue_stale_jobs():
    db = ManagerDB()
    tid = db.create_target("t")
    db.create_job(tid, "file", "afl", "nop")
    job = db.claim_job("w1")
    assert job is not None and db.claim_job("w2") is None
    assert db.requeue_stale_jobs(older_than_s=0.0) == 1
    assert db.claim_job("w2") is not None


def test_end_to_end_job_lifecycle(server, corpus_bin, tmp_path):
    """Full fleet loop in-process: job -> claim -> fuzz a real target
    -> assimilate crash -> results visible over REST."""
    seed = tmp_path / "seed.bin"
    seed.write_bytes(b"ABC@")  # one bit from the ABCD crash
    _, t = req(server, "/api/target",
               {"name": "corpus_test", "path": corpus_bin("test")})
    _, job = req(server, "/api/job", {
        "target_id": t["id"], "driver": "file",
        "instrumentation": "afl", "mutator": "bit_flip",
        "iterations": 32, "seed_file": str(seed),
        "driver_opts": json.dumps({"path": corpus_bin("test"),
                                   "arguments": "@@"})})
    done = work_loop(f"http://127.0.0.1:{server.port}", "pytest-worker",
                     once=True, in_process=True, device="cpu")
    assert done == 1
    code, results = req(server, f"/api/job/{job['id']}/results")
    assert code == 200
    kinds = {r["result_type"] for r in results}
    assert "crash" in kinds
    # repro file downloads and reproduces: content is the crasher
    crash = next(r for r in results if r["result_type"] == "crash")
    url = f"http://127.0.0.1:{server.port}{crash['repro_file']}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.read() == b"ABCD"
    # the worker re-verified the crash under the debug tier before
    # posting: the result row carries signal-level crash details
    info = json.loads(crash["crash_info"])
    assert info["verified"] is True
    assert info["tier"] == "debug"
    assert info["signal"] == 11          # SIGSEGV (NULL write)
    assert "description" in info
    _, full = req(server, f"/api/job/{job['id']}")
    assert full["status"] == "done"


def test_stats_endpoint_merges_two_workers(server):
    """Acceptance gate: POST two simulated workers' heartbeat
    snapshots, GET the merged fleet view — counters summed, gauges
    max'd, EMA rates weight-averaged (telemetry.aggregate)."""
    def snap(execs, corpus, rate, weight):
        return {"t": 1000.0 + execs, "start_time": 0.0,
                "counters": {"execs": execs, "new_paths": corpus},
                "gauges": {"corpus_size": corpus},
                "rates": {"execs": {"rate": rate, "weight": weight}}}

    code, _ = req(server, "/api/stats/7",
                  {"worker": "w1", "snapshot": snap(1000, 5, 800.0, 1.0)})
    assert code == 201
    code, _ = req(server, "/api/stats/7",
                  {"worker": "w2", "snapshot": snap(500, 9, 200.0, 1.0)})
    assert code == 201
    # latest-wins per worker: w1 heartbeats again with newer totals
    code, _ = req(server, "/api/stats/7",
                  {"worker": "w1", "snapshot": snap(2000, 6, 900.0, 1.0)})
    assert code == 201
    code, view = req(server, "/api/stats/7")
    assert code == 200
    assert view["n_workers"] == 2
    assert set(view["workers"]) == {"w1", "w2"}
    m = view["merged"]
    assert m["counters"]["execs"] == 2500          # summed, latest w1
    assert m["gauges"]["corpus_size"] == 9         # max
    assert abs(m["rates"]["execs"]["rate"] - 550.0) < 1e-6  # wtd mean
    # unknown campaign: empty, not an error
    code, view = req(server, "/api/stats/nope")
    assert code == 200
    assert view["n_workers"] == 0 and view["merged"] is None


def test_worker_job_heartbeats_progress(server, tmp_path):
    """The worker's job runner tails the fuzzer's stats.jsonl and
    POSTs it to /api/stats/<job id> (with a final beat at job end),
    so short in-process jobs still land one progress snapshot."""
    from killerbeez_tpu_torch.manager.worker import run_job
    seed = tmp_path / "seed.bin"
    seed.write_bytes(b"ABC@")
    _, t = req(server, "/api/target", {"name": "tgt-hb"})
    _, job = req(server, "/api/job", {
        "target_id": t["id"], "driver": "file",
        "instrumentation": "jit_harness", "mutator": "bit_flip",
        "iterations": 32, "seed_file": str(seed),
        "instrumentation_opts": json.dumps({"target": "test"})})
    full = req(server, f"/api/job/{job['id']}")[1]
    full["cmdline"] = job["cmdline"]
    status = run_job(f"http://127.0.0.1:{server.port}", full,
                     in_process=True, worker_name="hb-worker",
                     device="cpu")
    assert status == "done"
    code, view = req(server, f"/api/stats/{job['id']}")
    assert code == 200
    assert view["n_workers"] == 1
    assert view["merged"]["counters"]["execs"] == 32


def test_verify_repro_marks_network_findings_unverified():
    """VERDICT weak #5 pinned: a network-delivered crash cannot be
    replayed without the live session — its result row must carry an
    explicit verified=None marker (with the reason), never silently
    omit verification."""
    from killerbeez_tpu_torch.manager.worker import verify_repro
    job = {"instrumentation": "return_code",
           "driver": "network_server",
           "driver_opts": json.dumps({"path": "/bin/true",
                                      "port": 7000})}
    info = verify_repro(job, b"\x01\x02\x03")
    assert info["verified"] is None
    assert "not replayable" in info["reason"]
