"""The open loop's latency arithmetic on a fake pipeline: each frame timed
from its due time to the sink, a stall making the frames behind it late,
frames that never arrive counted as failed."""

from __future__ import annotations

import time

import numpy as np
import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark.lib.stats import nearest_rank
from benchmark.lib.stream import OpenSource, Recorder


class FakePipeline:
    """Hands frame k to the sink when frame k + 2 is pulled, as
    ``StreamPipeline.run`` does; sleeps ``stall`` seconds before handing
    on frame ``stall_at``; hands on nothing past frame ``stop_after``."""

    res_out = (2, 2)

    def __init__(self, stall_at, stall, stop_after):
        self.stall_at, self.stall, self.stop_after = stall_at, stall, \
            stop_after
        self.timer = type("T", (), {"totals": {"postprocess": 0.0}})()

    def run(self, source, sink):
        frame = np.zeros((2, 2, 3), np.uint8)
        for j, _ in enumerate(source):
            k = j - 2
            if k < 0 or k > self.stop_after:
                continue
            if k == self.stall_at:
                time.sleep(self.stall)
            sink(frame)


def _run(monkeypatch, rate=200.0, seconds=0.2, stall_at=None, stall=0.0,
         stop_after=10 ** 9):
    import benchmark.lib.stream as stream

    monkeypatch.setattr(stream.Recorder, "start_window",
                        _start_window_without_counters)
    pipe = FakePipeline(stall_at, stall, stop_after)
    rec = Recorder(pipe, seconds, 2, 5, traced=False)
    src = OpenSource([np.zeros((2, 2, 3), np.uint8)], rec, rate, 0.05)
    pipe.run(src, rec)
    return src, rec


def _start_window_without_counters(self, t):
    self.t_w0, self.t_end = t, t + self.seconds
    self.t_part = self.t_end
    self.totals0 = self.totals1 = dict(self.pipe.timer.totals)
    self.launches0 = self.launches1 = {}
    self.points = [self.window_index[0]]


def test_steady_latency_is_two_periods(monkeypatch):
    src, rec = _run(monkeypatch)
    lat = src.latencies_ms()
    assert len(lat) == 40 and src.first == 10 and src.missing() == 0
    # frame k reaches the sink when frame k + 2 is due: 2 periods of 5 ms
    assert nearest_rank(lat, 50) == pytest.approx(10.0, abs=2.0)
    assert rec.in_window == 40 and len(rec.kept) == 1


def test_a_stall_makes_the_frames_behind_it_late(monkeypatch):
    src, _ = _run(monkeypatch, stall_at=15, stall=0.05)
    lat = src.latencies_ms()
    k = 15 - src.first
    assert lat[k] >= 10.0 + 50.0 - 1.0
    assert lat[k + 1] > 30.0  # due before the stall ended, still waiting
    assert max(lat[:k]) < 20.0
    assert nearest_rank(lat, 95) >= 30.0


def test_frames_that_never_arrive_fail(monkeypatch):
    src, _ = _run(monkeypatch, stop_after=44)
    lat = src.latencies_ms()
    assert src.missing() == 5  # frames 45..49 of the window 10..49
    assert all(np.isfinite(lat)) and lat[-1] > 10.0
    assert nearest_rank(lat, 95) >= nearest_rank(lat[:-5], 95)


def test_nearest_rank():
    v = list(range(1, 101))
    assert nearest_rank(v, 95) == 95 and nearest_rank(v, 50) == 50
    assert nearest_rank([3.0], 95) == 3.0
    assert nearest_rank([1.0, float("inf")], 95) == float("inf")
