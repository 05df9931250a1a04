"""The readers of the program's device spans and host stages compute as
defined on a synthetic window, and leave their metric out where the
program has no such counter (a CPU run, or a program without them)."""

import pytest

from kbbench import readers
from kbbench.campaign import Window

NEW = ("triage.device_ms_per_batch", "kernels.device_ms_per_batch",
       "report.device_ms_per_batch", "loop.lead_ms",
       "device.between_share", "telemetry.share", "loop.checkpoint_share",
       "host.untimed_share")


class _Cell:
    traffic = {"check": "superbatch"}
    config = {"lanes": 1000}


def _reading(c0, c1, t0=10.0, snap=12.0, dispatches=4):
    w = Window(2.0, 1, 0, 0.5, False)
    w.t0, w.t1, w.t_snap1 = t0, t0 + 2.0, snap
    w.counters0, w.counters1 = c0, c1
    w.window_dispatches = dispatches
    return readers.Reading(w, _Cell(), 1.0)


def _window_counters():
    # 40 batches of 1000 lanes in a 2 s window, in 4 dispatches
    c0 = {"execs": 5000.0, "dev_triage_seconds": 1.0,
          "dev_kernels_seconds": 0.5, "dev_report_seconds": 0.1,
          "dev_dispatch_seconds": 3.0, "dev_between_seconds": 0.2,
          "dispatch_lead_seconds": 7.0, "telemetry_seconds": 0.1,
          "checkpoint_seconds": 0.0, "triage_self_seconds": 1.0,
          "execute_self_seconds": 0.5, "telemetry_self_seconds": 0.1}
    c1 = dict(c0, execs=45000.0, dev_triage_seconds=1.4,
              dev_kernels_seconds=0.524, dev_report_seconds=0.12,
              dev_dispatch_seconds=4.9, dev_between_seconds=0.3,
              dispatch_lead_seconds=7.6, telemetry_seconds=0.13,
              checkpoint_seconds=0.002, triage_self_seconds=1.5,
              execute_self_seconds=1.3, telemetry_self_seconds=0.13)
    return c0, c1


def _read(name, r):
    return readers.reader(name).read(r)


def test_readers_of_the_device_spans():
    r = _reading(*_window_counters())
    assert _read("triage.device_ms_per_batch", r) == pytest.approx(10.0)
    assert _read("kernels.device_ms_per_batch", r) == pytest.approx(0.6)
    assert _read("report.device_ms_per_batch", r) == pytest.approx(0.5)
    assert _read("loop.lead_ms", r) == pytest.approx(150.0)
    # 0.1 s between dispatches of 1.9 s of dispatch time
    assert _read("device.between_share", r) == pytest.approx(5.0)


def test_readers_of_the_host_stages():
    r = _reading(*_window_counters())
    assert _read("telemetry.share", r) == pytest.approx(1.5)
    assert _read("loop.checkpoint_share", r) == pytest.approx(0.1)
    # timed: 0.5 + 0.8 + 0.03 of 2 s
    assert _read("host.untimed_share", r) == pytest.approx(33.5)


@pytest.mark.parametrize("name", NEW)
def test_left_out_without_the_programs_counters(name):
    # a CPU run, or a program without the spans: only the counters it
    # had before, and a window that closed
    c = {"execs": 5000.0, "triage_seconds": 1.0,
         "host_transfer_seconds": 0.1}
    r = _reading(c, dict(c, execs=45000.0))
    assert _read(name, r) is None
    # and a window that never closed
    assert _read(name, _reading({}, {}, snap=None)) is None
