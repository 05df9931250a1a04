"""The device spans (``telemetry/device.py``) and the stage timers'
self time (``telemetry/metrics.py``).

On the CPU a fake card stands in for CUDA: its events take the card's
time when recorded and complete once the card's progress passes them,
so the folding into each counter, the host's lead, the gap between
dispatches, the trace's ``device`` lane and the rule that nothing
waits are checked exactly.  The one case that needs a card (a
``--trace`` campaign's ``trace.json``) skips without one; on a machine
with a card: ``python -m pytest --noconftest
tests/test_torch_device_spans.py -q``.
"""

import json

import pytest
import torch

from killerbeez_tpu_torch.telemetry import (
    DeviceSpans, MetricsRegistry, StageTimer, TraceRecorder,
)
from killerbeez_tpu_torch.telemetry.device import ANCHOR_ROUNDS

#: the anchor's waits: the fence, then one per round
ANCHOR_WAITS = 1 + ANCHOR_ROUNDS

torch.set_num_threads(1)


class _Card:
    """A stream's clock (``now``, seconds) and how far the card has
    executed (``progress``)."""

    def __init__(self):
        self.now = 10.0
        self.progress = 0.0
        self.made = 0
        self.waits = 0

    def event(self):
        self.made += 1
        return _Event(self)


class _Event:
    def __init__(self, card):
        self.card = card
        self.t = None

    def record(self):
        self.t = self.card.now

    def query(self):
        return self.card.progress >= self.t

    def synchronize(self):
        self.card.waits += 1
        self.card.progress = max(self.card.progress, self.t)

    def elapsed_time(self, end):
        if not (self.query() and end.query()):
            raise RuntimeError("cudaErrorNotReady")
        return (end.t - self.t) * 1e3


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


LAYERS = (("kernels", 0.001), ("triage", 0.010), ("report", 0.0005))


def _dispatch(sp, card, clock, batches, host_return):
    """Enqueue one dispatch of ``batches`` batches, each taking LAYERS'
    times on the card; the host's enqueue returns at ``host_return``."""
    sp.begin()
    for _ in range(batches):
        sp.batch()
        for layer, secs in LAYERS:
            card.now += secs
            sp.mark(layer)
    card.now += 0.002                 # the dispatch's stacking of outputs
    clock.t = host_return
    sp.end()


def _spans(tracer=None, clock=None):
    card, clock, reg = _Card(), clock or _Clock(), MetricsRegistry()
    sp = DeviceSpans(reg, tracer, new_event=card.event, clock=clock)
    return sp, card, clock, reg


def test_folds_each_layer_lead_and_between():
    sp, card, clock, reg = _spans()
    assert sp.anchor() == 100.0       # card 10.0 <-> host 100.0
    assert card.waits == ANCHOR_WAITS
    card.now = 10.5
    _dispatch(sp, card, clock, 8, host_return=100.2)
    card.now += 0.004                 # host copies between dispatches
    _dispatch(sp, card, clock, 8, host_return=100.3)
    card.progress = card.now
    sp.collect()
    c = reg.counters
    for layer, secs in LAYERS:
        assert c[f"dev_{layer}_seconds"] == pytest.approx(16 * secs)
    one = 8 * sum(s for _, s in LAYERS) + 0.002
    assert c["dev_dispatch_seconds"] == pytest.approx(2 * one)
    assert c["dev_between_seconds"] == pytest.approx(0.004)
    # the card reached the end marks at host 100.5 + one and
    # 100.5 + 2 one + 0.004; the enqueues returned at 100.2 and 100.3
    assert c["dispatch_lead_seconds"] == pytest.approx(
        (0.3 + one) + (0.2 + 2 * one + 0.004))
    assert all(k.endswith("_seconds") for k in c)
    assert card.waits == ANCHOR_WAITS     # only the anchor waited


def test_an_unfinished_dispatch_is_not_folded_and_nothing_waits():
    sp, card, clock, reg = _spans()
    sp.anchor()
    _dispatch(sp, card, clock, 2, host_return=100.1)
    first_end = card.now
    _dispatch(sp, card, clock, 2, host_return=100.2)
    card.progress = first_end - 1e-6  # the card is inside the first
    sp.collect()
    assert reg.counters == {}
    card.progress = first_end         # the first is done, not the second
    sp.collect()
    assert reg.counters["dev_triage_seconds"] == pytest.approx(0.02)
    assert "dev_between_seconds" not in reg.counters
    card.progress = card.now
    sp.collect()
    assert reg.counters["dev_triage_seconds"] == pytest.approx(0.04)
    assert card.waits == ANCHOR_WAITS


def test_events_come_from_a_pool():
    sp, card, clock, reg = _spans()
    sp.anchor()
    for i in range(50):
        _dispatch(sp, card, clock, 8, host_return=100.0 + i)
        card.progress = card.now
        sp.collect()
    # a dispatch of 8 batches records 2 + 8 x 4 events; the pool holds
    # one dispatch's, the anchor, the fence and the last end mark
    assert card.made <= 2 * (2 + 8 * 4) + 3
    assert reg.counters["dev_kernels_seconds"] == pytest.approx(
        50 * 8 * 0.001)


def test_marks_outside_a_dispatch_record_nothing():
    sp, card, clock, reg = _spans()
    sp.batch()
    sp.mark("kernels")
    sp.begin()                        # no anchor yet: not a dispatch
    sp.end()
    assert card.made == 0
    sp.anchor()
    made = card.made
    sp.batch()
    sp.mark("kernels")
    assert card.made == made


def test_a_new_anchor_folds_what_was_in_flight_and_no_gap_spans_runs():
    sp, card, clock, reg = _spans()
    sp.anchor()
    _dispatch(sp, card, clock, 1, host_return=100.1)
    card.now += 5.0                   # between two run() calls
    clock.t = 100.0 + (card.now - 10.0) + 2e-6
    # waits: the first dispatch folds; the new anchor is the middle of
    # its round's two clock reads
    assert sp.anchor() == pytest.approx(clock.t)
    assert reg.counters["dev_dispatch_seconds"] > 0
    ev = card.event()
    ev.record()
    ev.synchronize()
    assert sp.host_time(ev) == pytest.approx(clock.t)
    _dispatch(sp, card, clock, 1, host_return=101.0)
    card.progress = card.now
    sp.collect()
    assert "dev_between_seconds" not in reg.counters


def test_device_lane_in_the_trace():
    clock = _Clock()
    tr = TraceRecorder(max_events=256, clock=clock)
    sp, card, _, reg = _spans(tr, clock)
    sp.anchor(marker=lambda: None)
    card.now = 10.5
    _dispatch(sp, card, clock, 2, host_return=100.1)
    card.progress = card.now
    sp.collect()
    doc = tr.to_chrome()
    lane = tr.lane_id("device")
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["tid"] == lane}
    assert names == {"device"}
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["tid"] == lane]
    assert [e["name"] for e in spans] == [
        "kernels", "triage", "report"] * 2 + ["dispatch"]
    # on the host's clock: the trace's zero is host 100.0, the card's
    # 10.5 is host 100.5
    assert spans[0]["ts"] == pytest.approx(0.5e6)
    assert spans[0]["dur"] == pytest.approx(1e3)
    assert spans[1]["ts"] == pytest.approx(0.501e6)
    sync = [e for e in doc["traceEvents"] if e["name"] == "clock_sync"]
    assert len(sync) == 1 and sync[0]["ts"] == 0.0
    json.dumps(doc)


def test_nested_stages_self_times_sum_to_the_outer_span():
    reg = MetricsRegistry()
    clock = _Clock(0.0)
    timer = StageTimer(reg, clock=clock)
    with timer("corpus_feedback"):
        clock.t += 1.0
        with timer("triage"):
            clock.t += 2.0
            with timer("fs_write"):
                clock.t += 4.0
            clock.t += 8.0
        with timer("telemetry"):
            clock.t += 16.0
        clock.t += 32.0
    c = reg.counters
    assert c["corpus_feedback_seconds"] == 63.0
    assert c["triage_seconds"] == 14.0 and c["fs_write_seconds"] == 4.0
    assert c["corpus_feedback_self_seconds"] == 33.0
    assert c["triage_self_seconds"] == 10.0
    assert c["telemetry_self_seconds"] == 16.0
    assert sum(v for k, v in c.items() if k.endswith("_self_seconds")) \
        == c["corpus_feedback_seconds"]
    assert timer._stack == []
    # the histograms are the stage's whole spans, as before
    assert reg.hists["triage"].sum == 14.0


def test_a_span_that_raises_still_closes():
    reg = MetricsRegistry()
    clock = _Clock(0.0)
    timer = StageTimer(reg, clock=clock)
    with pytest.raises(ValueError):
        with timer("triage"):
            clock.t += 1.0
            raise ValueError
    with timer("execute"):
        clock.t += 2.0
    assert reg.counters["triage_self_seconds"] == 1.0
    assert reg.counters["execute_self_seconds"] == 2.0


def _timeline_doc(device_lane):
    """A trace of three dispatches (ms): the host's ``execute`` spans
    (0-50, 56-106, 110-160) hold its wait for the card; between them
    it runs ``triage``, then ``telemetry`` (51-56), then code in no
    stage (107-110).  On the card the dispatches run 10-51.5,
    56-107.5 and 110-160, each with two 15 ms ``triage`` spans."""
    clock = _Clock(0.0)
    tr = TraceRecorder(max_events=256, clock=clock)
    timer = StageTimer(MetricsRegistry(), tr, clock=clock)
    for stage, ms in (("execute", 50), ("triage", 1), ("telemetry", 5),
                      ("execute", 50), ("triage", 1), (None, 3),
                      ("execute", 50), ("triage", 1)):
        if stage is None:
            clock.t += ms / 1e3
            continue
        with timer(stage):
            clock.t += ms / 1e3
    if device_lane:
        lane = tr.lane_id("device")
        for t0, t1 in ((0.010, 0.0515), (0.056, 0.1075), (0.110, 0.160)):
            for a in (t0 + 0.001, t0 + 0.020):
                tr.complete("triage", a, a + 0.015, lane)
            tr.complete("dispatch", t0, t1, lane)
    return tr.to_chrome()


def test_kb_timeline_takes_bubbles_from_the_device_lane():
    from killerbeez_tpu_torch.tools import timeline_tool as tl

    report = tl.build_report(_timeline_doc(True), [], {}, bubble_us=1000)
    assert [(b["dominant_stage"], round(b["duration_us"]))
            for b in report["bubbles"]] == [("telemetry", 4500),
                                            ("untimed", 2500)]
    dv = report["device"]
    assert dv["dispatches"] == 3
    assert dv["layers_us"]["triage"] == pytest.approx(6 * 15e3)
    assert dv["busy_share"] == pytest.approx(143 / 150)
    # the device lane's triage spans are not the host's triage stage
    assert report["stages"]["triage"]["count"] == 3
    text = tl.render(report, [])
    assert "device lane   : 3 dispatches" in text
    assert "while host ran telemetry" in text


def test_kb_timeline_without_a_device_lane_reads_as_the_jax_tool():
    from killerbeez_tpu.tools import timeline_tool as jax_tl
    from killerbeez_tpu_torch.tools import timeline_tool as tl

    doc = _timeline_doc(False)
    assert tl.device_spans_from_chrome(doc) == []
    for bubble_us in (None, 1000):
        got = tl.build_report(doc, [], {}, bubble_us=bubble_us)
        assert got == jax_tl.build_report(doc, [], {}, bubble_us=bubble_us)
        assert "device" not in got


@pytest.mark.device
def test_trace_json_holds_the_device_lane(tmp_path):
    """A ``--trace`` campaign on the card: trace.json's ``device`` lane
    holds each batch's kernels, triage and report spans on the host's
    clock, inside the run, and the registry holds their counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device spans are CUDA events")
    from killerbeez_tpu_torch.fuzzer.cli import main
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    from killerbeez_tpu_torch.telemetry import read_latest_snapshot

    seed = tmp_path / "seed.bin"
    seed.write_bytes(tlvstack_vm_seed())
    out = tmp_path / "out"
    batches = 4 * 8
    assert main(["file", "jit_harness", "havoc", "-sf", str(seed),
                 "-b", "4096", "-n", str(batches * 4096), "-o", str(out),
                 "-i", '{"target": "tlvstack_vm", "engine": "cuda_fused",'
                 ' "novelty": "throughput"}', "--trace"]) == 0
    doc = json.loads((out / "trace.json").read_text())
    lanes = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    dev = [e for e in doc["traceEvents"]
           if e["ph"] == "X" and e["tid"] == lanes["device"]]
    for layer in ("kernels", "triage", "report"):
        assert sum(e["name"] == layer for e in dev) == batches
    # a batch's first mark is recorded inside the driver's execute
    # stage, so the card reaches it after the stage opened
    host = [e["ts"] for e in doc["traceEvents"]
            if e["ph"] in "BE" and e["name"] == "execute"]
    assert min(host) < min(e["ts"] for e in dev if e["name"] == "kernels")
    assert all(e["dur"] > 0 for e in dev)
    c = read_latest_snapshot(str(out))["counters"]
    for key in ("dev_kernels_seconds", "dev_triage_seconds",
                "dev_report_seconds", "dev_dispatch_seconds",
                "dev_between_seconds", "telemetry_self_seconds",
                "checkpoint_self_seconds"):
        assert c[key] > 0, key
    # a campaign this small is host-paced: the card reaches each end
    # mark about when the host records it, within the launch latency
    assert abs(c["dispatch_lead_seconds"]) < 4 * 0.05
    # kb-timeline reads the lane: dispatches and bubbles from the card
    from killerbeez_tpu_torch.tools import timeline_tool
    report = timeline_tool.build_report(*timeline_tool.analyze(str(out)))
    assert report["device"]["dispatches"] == sum(
        e["name"] == "dispatch" for e in dev) > 0
    assert set(report["device"]["layers_us"]) == {
        "kernels", "triage", "report"}
