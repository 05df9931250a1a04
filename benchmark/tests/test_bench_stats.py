"""The end-to-end metrics and the device metrics compute as defined,
on synthetic clocks and a synthetic profiler trace."""

import pytest

from kbbench import devtrace, readers, stats
from kbbench.campaign import Window


class _Cell:
    traffic = {"check": "superbatch"}


def _window(dispatched, step_ends, t0, seconds):
    w = Window(seconds, 1, 0, 0.5, False)
    w.t0, w.t1 = t0, t0 + seconds
    w.dispatched, w.step_ends = dispatched, step_ends
    w.t_snap1 = w.t1 + 0.05
    return w


def test_execs_per_s_counts_all_the_window_and_only_it():
    # dispatches of 100 every 0.1 s from t = 10.0; the window is (10, 12]
    dispatched = [(10.0 + 0.1 * i, 100) for i in range(31)]
    w = _window(dispatched, [], 10.0, 2.0)
    r = readers.Reading(w, _Cell(), 1.0)
    # the one at t0 itself is the warm-up's; 20 end in (10, 12]
    assert readers.reader("execs_per_s").read(r) == pytest.approx(
        20 * 100 / 2.0)


def test_step_ms_p95_is_the_tail_of_every_step():
    t0 = 5.0
    gaps = [0.1] * 95 + [1.0] * 5          # 100 steps, 5 long ones
    ends, t = [], t0
    for g in gaps:
        t += g
        ends.append(t)
    ends.append(t + 5.0)                    # past the window: left out
    w = _window([], ends, t0, t - t0 + 0.001)
    r = readers.Reading(w, _Cell(), 1.0)
    got = readers.reader("step_ms_p95").read(r)
    assert len(stats.step_intervals(ends, w.t0, w.t1)) == 100
    # numpy's linear percentile of 95 x 0.1 and 5 x 1.0
    import numpy as np
    assert got == pytest.approx(1e3 * np.percentile(gaps, 95))


def test_percentile():
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile([0, 10], 95) == pytest.approx(9.5)


def _stretch():
    M = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [
        (M, 990, 1000), (M, 2000, 2010),        # the fence
        (M, 9990, 10000),                        # the calibration marker
        # one straddling the start, two overlapping, one after the end
        ("void kbz_fuzz_kernel<1>", 900, 1100),
        ("elementwise_kernel", 1200, 1300),
        ("Memcpy DtoH", 1250, 1350),
        ("elementwise_kernel", 1600, 1900),
        ("late", 2100, 2150),
    ]
    # the host's clock runs 5000 ns behind the card's: the calibration
    # marker started at 9990 on the card, launched at 4990 on the host
    stages = [("triage", 1350 - 5000, 1550 - 5000),
              ("corpus_feedback", 0, 100)]
    return devtrace.reduce(events, stages, 4990)


def test_device_idle_share_from_a_stretch():
    st = _stretch()
    # busy: [1000, 1100] + [1200, 1350] + [1600, 1900] = 550 of 1000 ns
    assert st.busy_ns == pytest.approx(550.0)
    assert st.window_ns == 1000
    r = readers.Reading(_window([], [], 0.0, 1.0), _Cell(), 1.0, st)
    assert readers.reader("device.idle_share").read(r) == \
        pytest.approx(45.0)
    # gaps: (1100, 1200) untimed, (1350, 1600) in triage at its middle,
    # (1900, 2000) untimed; the longest first
    assert st.gaps[0] == ("triage", pytest.approx(250.0))
    assert sorted(g for _, g in st.gaps) == pytest.approx([100, 100, 250])
    assert devtrace.torch_op_ns(st) == pytest.approx(100 + 100 + 300)
    b = devtrace.breakdown(st)
    assert b["device_ops"][0] == ["elementwise_kernel",
                                  pytest.approx(400e-9)]
    assert len(b["idle_gaps"]) == 3


def test_no_fence_no_stretch():
    assert devtrace.reduce([("k", 0, 10)], [], 0) is None


def test_readers_leave_out_what_they_cannot_read():
    w = _window([], [], 0.0, 1.0)
    r = readers.Reading(w, _Cell(), 1.0)
    for name in ("device.idle_share", "step.roofline_share",
                 "torch_ops.device_ms_per_batch", "gen.enqueue_ms",
                 "step_ms_p95"):
        assert readers.reader(name).read(r) is None


def test_stage_share_reads_the_counters():
    w = _window([], [], 10.0, 2.0)
    w.counters0 = {"host_transfer_seconds": 1.0}
    w.counters1 = {"host_transfer_seconds": 1.5}
    w.t_snap1 = 12.5
    r = readers.Reading(w, _Cell(), 1.0)
    assert readers.reader("loop.wait_share").read(r) == pytest.approx(20.0)
    assert readers.reader("loop.fs_write_share").read(r) == 0.0
