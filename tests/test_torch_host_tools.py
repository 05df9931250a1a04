"""The port's host-only tools against the JAX package's, on the CPU.

A port campaign (the CLI at the default ``-fb`` on ``cgc_like`` with
``--trace`` and a corpus store) writes its output once; on those same
files kb-corpus (``ls``, ``stats``, ``heat``), kb-heat (``tools/heat.py``,
also over the store with provenance sidecars added, so the panels
render), kb-timeline (human, ``--json``, ``--heat``) and kb-stats
(``--once``, ``--json``, ``--openmetrics``, the last parsed by
``tests/openmetrics_parser.py``) print what the JAX package's tools
print.  kb-fleet runs against a stub manager served by a thread inside
the test.  And the per-shard kb-timeline case of
``tests/test_mesh_generations.py``: a dp = 4 ``-G`` mesh campaign's
trace yields one generations row per shard.  Tolerance: none (the
clock is fixed for the age columns)."""

import io
import json
import os
import shutil
import threading
import time
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from killerbeez_tpu.tools import corpus_tool as jax_corpus_tool
from killerbeez_tpu.tools import fleet_tool as jax_fleet_tool
from killerbeez_tpu.tools import heat as jax_heat
from killerbeez_tpu.tools import stats_tui as jax_stats_tui
from killerbeez_tpu.tools import timeline_tool as jax_timeline_tool
from killerbeez_tpu_torch.corpus.store import CorpusStore
from killerbeez_tpu_torch.fuzzer.cli import main as cli_main
from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)
from killerbeez_tpu_torch.learn.dataset import make_provenance
from killerbeez_tpu_torch.mutators.randomized import HavocMutator
from killerbeez_tpu_torch.parallel import ShardedCampaignDriver
from killerbeez_tpu_torch.telemetry.sink import parse_fuzzer_stats
from killerbeez_tpu_torch.tools import corpus_tool, fleet_tool, heat
from killerbeez_tpu_torch.tools import stats_tui, timeline_tool
from openmetrics_parser import parse_openmetrics, sample_value

torch.set_num_threads(1)

SEED = b"CG\x02\x04\x05\x41xx"
NOW = 2_000_000_000.0


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """One port campaign's output dir (default -fb: corpus feedback,
    stats files, events, a span trace) and its seed file."""
    d = tmp_path_factory.mktemp("campaign")
    seed = d / "seed.bin"
    seed.write_bytes(SEED)
    out = d / "out"
    rc = cli_main(["file", "jit_harness", "havoc", "--device", "cpu",
                   "-i", '{"target": "cgc_like"}', "-m", '{"seed": 11}',
                   "-sf", str(seed), "-o", str(out), "-b", "256", "-n",
                   "4096", "--corpus-dir", str(out / "corpus"),
                   "--trace", "65536", "--stats-interval", "0.1"])
    assert rc == 0
    assert len(CorpusStore(str(out / "corpus")).load()) > 1
    return out, seed


def _both(port_main, jax_main, argv, monkeypatch, capsys):
    """(rc, stdout) of the port's tool and the JAX package's on argv,
    with the clock fixed."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    got = []
    for fn in (port_main, jax_main):
        rc = fn(list(argv))
        got.append((rc, capsys.readouterr().out))
    return got


@pytest.mark.parametrize("cmd", [["ls"], ["stats"],
                                 ["heat", "--no-color", "--base"]],
                         ids=["ls", "stats", "heat"])
def test_kb_corpus_matches_jax(cmd, campaign, monkeypatch, capsys):
    out, seed = campaign
    argv = [cmd[0], str(out / "corpus"), *cmd[1:]]
    if argv[-1] == "--base":
        argv.append(str(seed))
    mine, ref = _both(corpus_tool.main, jax_corpus_tool.main, argv,
                      monkeypatch, capsys)
    assert mine == ref and mine[0] == 0 and mine[1]


@pytest.fixture(scope="module")
def labeled_store(campaign, tmp_path_factory):
    """The campaign's store with a provenance sidecar on every entry
    (its child-vs-parent byte diff), so the heat panels have lineage
    to render."""
    out, seed = campaign
    d = tmp_path_factory.mktemp("labeled") / "corpus"
    shutil.copytree(out / "corpus", d)
    store = CorpusStore(str(d))
    entries = store.load()
    by_md5 = {e.md5: e.buf for e in entries}
    for e in entries:
        parent = by_md5.get(e.parent, SEED)
        e.provenance = make_provenance(parent, e.buf, "havoc")
        store.update_meta(e)
    return d


def test_kb_heat_matches_jax(labeled_store, campaign, monkeypatch, capsys):
    _, seed = campaign
    entries = CorpusStore(str(labeled_store)).load()
    assert any(e.provenance for e in entries)
    for kw in ({}, {"top": 2, "width": 8}, {"color": True}):
        assert heat.render_store_heat(entries, base=SEED, **kw) == \
            jax_heat.render_store_heat(entries, base=SEED, **kw)
    mine = heat.heat_report(entries, base=SEED)
    assert mine == jax_heat.heat_report(entries, base=SEED)
    assert mine, "no heat panel rendered"
    argv = ["heat", str(labeled_store), "--no-color", "--base", str(seed)]
    got, ref = _both(corpus_tool.main, jax_corpus_tool.main, argv,
                     monkeypatch, capsys)
    assert got == ref and got[0] == 0


@pytest.mark.parametrize("extra", [[], ["--json"], ["--heat", "--no-lanes"],
                                   ["--width", "100", "--bubble-ms", "5"]],
                         ids=["human", "json", "heat", "wide"])
def test_kb_timeline_matches_jax(extra, campaign, monkeypatch, capsys):
    out, seed = campaign
    argv = [str(out), *extra]
    if "--heat" in extra:
        argv += ["--base", str(seed)]
    mine, ref = _both(timeline_tool.main, jax_timeline_tool.main, argv,
                      monkeypatch, capsys)
    assert mine == ref and mine[0] == 0 and mine[1]
    if extra == ["--json"]:
        doc = json.loads(mine[1])
        assert doc


@pytest.mark.parametrize("extra", [[], ["--json"], ["--openmetrics"]],
                         ids=["frame", "json", "openmetrics"])
def test_kb_stats_matches_jax(extra, campaign, monkeypatch, capsys):
    out, _ = campaign
    argv = [str(out), "--once", *extra]
    mine, ref = _both(stats_tui.main, jax_stats_tui.main, argv,
                      monkeypatch, capsys)
    assert mine == ref and mine[0] == 0 and mine[1]
    if extra == ["--openmetrics"]:
        fams = parse_openmetrics(mine[1])
        execs = int(parse_fuzzer_stats(str(out / "fuzzer_stats"))[
            "execs_done"])
        assert sample_value(fams, "kbz_execs", "kbz_execs_total",
                            {}) == execs


def test_kb_stats_once_gates_on_missing_stats(tmp_path, capsys):
    assert stats_tui.main([str(tmp_path), "--once"]) == 1
    assert "no campaign stats" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# kb-fleet against a stub manager
# ---------------------------------------------------------------------------

FLEET = {
    "/api/fleet": {"campaigns": {
        "7": {"n_workers": 2, "healthy": 1, "stale": 0, "dead": 1}}},
    "/api/fleet/7": {
        "campaign": "7", "t": NOW, "n_workers": 2,
        "counts": {"healthy": 1, "stale": 0, "dead": 1},
        "config": {"stale_after": 30.0, "dead_after": 120.0},
        "merged": {"counters": {"execs": 1500, "new_paths": 9,
                                "crashes": 4, "unique_crashes": 2,
                                "hangs": 0},
                   "rates": {"execs": {"rate": 1234.5}}},
        "alerts": [{"alert": "worker_death", "active": True,
                    "since": NOW - 75.0, "details": {"worker": "w2"}}],
        "workers": {
            "w1": {"status": "healthy", "age": 1.5,
                   "stats": {"execs": 1000, "execs_per_sec_ema": 900.0,
                             "new_paths": 7, "crashes": 3, "hangs": 0}},
            "w2": {"status": "dead", "age": 300.0,
                   "meta": {"tier": "tpu"},
                   "stats": {"execs": 500, "execs_per_sec_ema": 0.0,
                             "new_paths": 2, "crashes": 1,
                             "hangs": 0}}}},
    "/api/fleet/ghost": {"campaign": "ghost", "n_workers": 0},
}
PLOT = "# unix_time, execs\n1, 10\n2, 20\n"


class _Stub(BaseHTTPRequestHandler):
    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path == "/api/fleet/7/series" and query == "format=plot":
            body, ctype = PLOT.encode(), "text/plain"
        elif path in FLEET:
            body, ctype = json.dumps(FLEET[path]).encode(), \
                "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def stub_manager():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("extra,rc", [
    ([], 0), (["--campaign", "7"], 0), (["--campaign", "7", "--json"], 0),
    (["--campaign", "7", "--plot-data"], 0),
    (["--campaign", "ghost", "--json"], 1), (["--plot-data"], 2),
], ids=["index", "table", "json", "plot", "ghost", "plot-needs-campaign"])
def test_kb_fleet_against_stub_manager(extra, rc, stub_manager,
                                       monkeypatch, capsys):
    got = []
    monkeypatch.setattr(time, "time", lambda: NOW)
    for fn in (fleet_tool.main, jax_fleet_tool.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            code = fn([stub_manager, *extra])
        got.append((code, buf.getvalue(), capsys.readouterr().err))
    assert got[0] == got[1] and got[0][0] == rc
    out = got[0][1]
    if extra == ["--campaign", "7"]:
        assert "worker_death active" in out
        assert "dead" in out and "healthy" in out
    elif extra == ["--campaign", "7", "--json"]:
        body = json.loads(out)
        assert {w: v["status"] for w, v in body["workers"].items()} == \
            {"w1": "healthy", "w2": "dead"}
    elif "--plot-data" in extra and rc == 0:
        assert out == PLOT
    elif rc == 1:
        assert "no workers seen" in got[0][2]


# ---------------------------------------------------------------------------
# kb-timeline: per-shard occupancy of a mesh -G campaign
# ---------------------------------------------------------------------------


def test_timeline_reports_per_shard_generation_occupancy(tmp_path):
    """A dp = 4 ``-G`` ``--trace`` mesh campaign yields a kb-timeline
    generations section with one row per dp shard (dispatch and
    generation totals, occupancy over the generation window) and a
    device-bound verdict; the JAX tool's report on the same trace is
    the same."""
    instr = JitHarnessInstrumentation('{"target": "cgc_like"}',
                                      device="cpu")
    mut = HavocMutator('{"seed": 11}', SEED, device="cpu")
    drv = ShardedCampaignDriver("4,1", instr, mut, batch_size=256)
    fz = Fuzzer(drv, output_dir=str(tmp_path / "o"), batch_size=256,
                feedback=0, generations=4, trace=65536)
    fz.run(4096)
    with open(tmp_path / "o" / "trace.json") as f:
        doc = json.load(f)
    report = timeline_tool.build_report(doc, None, None)
    assert report == jax_timeline_tool.build_report(doc, None, None)
    gr = report.get("generations")
    assert gr and gr["dispatches"] >= 2
    assert gr["n_shards"] == 4
    assert set(gr["shards"]) == {"0", "1", "2", "3"}
    for sd in gr["shards"].values():
        assert sd["dispatches"] == gr["dispatches"]
        assert sd["generations_total"] == gr["generations_total"]
        assert sd["occupancy"] > 0.5
    assert gr["device_bound"], (
        f"host stages on the critical path: device "
        f"{gr['device_occupancy']:.1%} vs host "
        f"{gr['host_occupancy']:.1%}")
    assert os.path.exists(tmp_path / "o" / "fuzzer_stats")
