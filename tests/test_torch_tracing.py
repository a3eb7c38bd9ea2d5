"""The stream pipeline's per-frame spans (``profiling.FrameTrace`` set on
``StreamPipeline.trace``) on the CPU, on a BicubicInterpolation pipeline at
16x16 -> 32x32 as in tests/test_torch_stream.py.

With a trace set: one record a frame, in order; every child span inside its
parent; the pull and preprocess spans on the producer's thread; the
``StageTimer`` totals the sums of the same readings; the ring bounded by
its capacity; the Chrome-trace export (also the stream CLI's
``--trace_out``) valid JSON; the first resolution of a profiler session
named apart, since it holds the profiler's start-up; on a paced source with
a stand-in device, the benchmark's chain of segments covering each frame's
latency, none of it held. Without one: no record, the timer's report JAX's
text, and the main thread's take of the next frame a profiler range. The
device intervals and the anchor run on the card only
(tests/test_torch_gpu.py ``-k frame_trace``).
"""

import json
import statistics
import threading
import time

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import profiling
from transformerupscaler_torch.stream_lib import StreamPipeline

HOST_SPANS = ("pipeline.frame", "pipeline.pull", "pipeline.preprocess",
              "pipeline.preprocess_wait", "pipeline.dispatch",
              "pipeline.fetch", "pipeline.sink")


def _pipe():
    return StreamPipeline("BicubicInterpolation", (16, 16), (32, 32),
                          params={}, device="cpu")


def _frames(n, seed=0):
    return list(np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3),
                                                     np.uint8))


def _traced_run(n=8, capacity=64, **kw):
    pipe = _pipe()
    pipe.trace = profiling.FrameTrace(capacity)
    outs = []
    stats = pipe.run(iter(_frames(n)), sink=outs.append, **kw)
    return pipe, outs, stats


def _dur(rec, name):
    start, end = rec.times[name]
    return end - start


def test_every_frame_has_one_record_in_order():
    pipe, outs, stats = _traced_run(8)
    recs = list(pipe.trace.frames)
    assert stats["frames"] == len(outs) == len(recs) == 8
    assert [r.n for r in recs] == list(range(8))
    for r in recs:
        assert set(r.times) == set(HOST_SPANS)
        assert r.events is None and not r.new_array


def test_children_lie_inside_their_parents_on_their_threads():
    workers = set()

    def preprocess(frame):
        workers.add(threading.get_native_id())
        return np.ascontiguousarray(frame)

    pipe, _, _ = _traced_run(8, preprocess=preprocess)
    main = threading.get_native_id()
    (worker,) = workers
    assert worker != main
    for rec in pipe.trace.frames:
        spans = {s.name: s for s in rec.spans()}
        for s in spans.values():
            assert s.frame == rec.n and s.start <= s.end
            if s.parent is not None:
                p = spans[s.parent]
                assert p.start <= s.start and s.end <= p.end, s.name
        producer = {"pipeline.pull", "pipeline.preprocess"}
        assert {spans[n].tid for n in producer} == {worker}
        assert {s.tid for n, s in spans.items()
                if n not in producer} == {main}
        # The frame's path in order: pulled and preprocessed on the
        # producer, taken, dispatched, fetched, handed to the sink.
        order = [spans[n] for n in ("pipeline.pull", "pipeline.preprocess",
                                    "pipeline.dispatch", "pipeline.fetch",
                                    "pipeline.sink")]
        assert (spans["pipeline.preprocess"].end
                <= spans["pipeline.preprocess_wait"].end
                <= spans["pipeline.dispatch"].start)
        assert all(a.end <= b.start for a, b in zip(order, order[1:]))


def test_stage_totals_are_the_sums_of_the_spans():
    pipe, _, _ = _traced_run(9)
    recs, totals = list(pipe.trace.frames), pipe.timer.totals
    for stage, span in (("preprocess", "pipeline.preprocess_wait"),
                        ("postprocess", "pipeline.fetch"),
                        ("display", "pipeline.sink")):
        assert totals[stage] == pytest.approx(
            sum(_dur(r, span) for r in recs), rel=1e-9, abs=1e-12)
    assert totals["inference"] == pytest.approx(
        sum(r.times["pipeline.fetch"][1] - r.times["pipeline.dispatch"][0]
            for r in recs), rel=1e-9)
    # Every pulled frame counts under capture, and every one is delivered,
    # so has its record.
    assert totals["capture"] == pytest.approx(
        sum(_dur(r, "pipeline.pull") for r in recs), rel=1e-9, abs=1e-12)


def test_the_ring_holds_at_most_its_capacity():
    pipe, outs, _ = _traced_run(11, capacity=3)
    assert len(outs) == 11
    assert [r.n for r in pipe.trace.frames] == [8, 9, 10]


def test_without_a_trace_no_record_and_the_report_is_jax_text():
    from transformerupscaler_tpu.stream_lib import StageTimer as JaxTimer

    pipe = _pipe()
    trace = profiling.FrameTrace()
    pipe.trace = trace
    pipe.run(iter(_frames(4)))
    assert len(trace.frames) == 4
    pipe.trace = None
    stats = pipe.run(iter(_frames(5)), sink=lambda f: None)
    assert len(trace.frames) == 4 and pipe.trace is None
    theirs = JaxTimer(list(pipe.timer.totals))
    theirs.totals = dict(pipe.timer.totals)
    theirs.iterations = pipe.timer.iterations
    assert stats["report"] == theirs.report()
    assert pipe.timer.iterations == 9


def test_new_frame_arrays_counts_only_frames_it_cannot_reuse():
    import torch

    pipe = _pipe()
    pipe._host_out = [torch.empty(4, 4, 3, dtype=torch.uint8)]
    pipe._handed = []
    before = dict(profiling.COUNTERS)["new_frame_arrays"]
    held = [pipe._frame_array() for _ in range(3)]
    assert dict(profiling.COUNTERS)["new_frame_arrays"] == before + 3
    del held
    for _ in range(5):
        pipe._frame_array()
    assert dict(profiling.COUNTERS)["new_frame_arrays"] == before + 3
    assert set(dict(profiling.COUNTERS)) == {
        "bytes_in", "bytes_out", "new_frame_arrays", "frames_retired_alone",
        "frames_retired_behind", "graph_captures", "kernel_builds"}


def test_chrome_trace_export_loads_as_json(tmp_path):
    pipe, _, _ = _traced_run(6)
    path = tmp_path / "frames.json"
    pipe.trace.write_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) == 6 * (len(HOST_SPANS) - 1)
    assert {e["args"]["frame"] for e in spans} == set(range(6))
    begins = [e for e in events if e["ph"] == "b"]
    assert [e["id"] for e in begins] == list(range(6))
    assert all(e["dur"] >= 0 and e["pid"] > 0 for e in spans)


def test_stream_cli_writes_the_frame_trace(tmp_path, capsys, monkeypatch):
    from transformerupscaler_torch import stream as stream_cli

    monkeypatch.setitem(stream_cli.resolutions, "t16", (16, 32))
    monkeypatch.setitem(stream_cli.resolutions, "t32", (32, 64))
    path = tmp_path / "frames.json"
    stats = stream_cli.main(stream_cli.parser().parse_args(
        ["--model", "BicubicInterpolation", "--res_in", "t16", "--res_out",
         "t32", "--frames", "4", "--device", "cpu", "--trace_out",
         str(path)]))
    assert stats["frames"] == 4
    assert f"4 frames' spans written to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(e["name"] == "pipeline.sink" for e in events) == 4


def test_spans_are_profiler_ranges_while_a_session_is_active():
    from torch.profiler import ProfilerActivity, profile

    pipe = _pipe()
    pipe.trace = profiling.FrameTrace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run(iter(_frames(5)))
    names = {e.name for e in prof.events() if e.name.startswith("pipeline.")}
    # The session records the thread that started it, so the producer's
    # ``pipeline.pull`` and ``pipeline.preprocess`` are in the records
    # only; three frames are in flight at once, so ``pipeline.frame``
    # cannot nest as a range.
    assert names == set(HOST_SPANS) - {"pipeline.frame", "pipeline.pull",
                                       "pipeline.preprocess"} | {
        "pipeline.loop"}


def test_the_take_is_a_profiler_range_without_a_trace():
    """The main thread's wait for the next frame (the source's wait, on the
    producer) is named in a profiler session with no trace set."""
    from torch.profiler import ProfilerActivity, profile

    pipe = _pipe()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run(iter(_frames(5)))
    takes = [e for e in prof.events() if e.name.startswith("pipeline.")]
    assert {e.name for e in takes} == {"pipeline.preprocess_wait"}
    assert len(takes) == 6  # five frames and the end of the source


def test_the_first_resolution_in_a_profiler_session_has_its_own_name():
    from torch.profiler import ProfilerActivity, profile

    trace = profiling.FrameTrace()
    assert trace._resolve_range() == "pipeline.resolve"
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            assert trace._resolve_range() == "profiler.first_resolve"
            assert trace._resolve_range() == "pipeline.resolve"
        assert trace._resolve_range() == "pipeline.resolve"


def test_a_paced_frame_is_held_nowhere():
    """Frame j due at t0 + j * period, a stand-in device (16 ms of work
    from the dispatch, its interval put into the record as the card's
    events would be; the fetch's wait is its whole span on the CPU): the
    benchmark's chain of segments covers each frame's latency, and the
    frame is held by nothing but the hand-off between threads."""
    from benchmark.lib.frames import chain_ms, held_ms

    period, d_dev, n = 0.040, 0.016, 8
    pipe = _pipe()
    ready = {}

    class Pending:
        def __init__(self, t):
            self.t = t

        def __array__(self, dtype=None, copy=None):
            time.sleep(max(0.0, self.t - time.perf_counter()))
            return np.zeros((32, 32, 3), np.uint8)

    def step(frame):
        t = time.perf_counter()
        ready[len(ready)] = (t, t + d_dev)
        return Pending(t + d_dev)

    pipe._step = step
    due, arrivals = [], []

    def source():
        t0 = time.perf_counter() + 0.01
        for j, frame in enumerate(_frames(n)):
            due.append(t0 + j * period)
            time.sleep(max(0.0, due[j] - time.perf_counter()))
            yield frame

    pipe.trace = profiling.FrameTrace()
    pipe.run(source(), sink=lambda f: arrivals.append(time.perf_counter()))
    chains, held = [], []
    for rec in pipe.trace.frames:
        t = dict(rec.times)
        start, end = ready[rec.n]
        t["device.copy_in"] = t["device.graph"] = (start, start)
        t["device.copy_out"] = (start, end)
        t["pipeline.fetch_wait"] = t["pipeline.fetch"]
        t["pipeline.copy_out"] = (t["pipeline.fetch"][1],) * 2
        chains.append(chain_ms(t, due[rec.n], arrivals[rec.n]))
        held.append(held_ms(t))
    assert len(chains) == n
    assert statistics.median(c["unaccounted"] for c in chains) < 0.2
    assert statistics.median(held) < 0.05 * period * 1e3, held
    assert all(c["fetch wait"] > 0.5 * d_dev * 1e3 for c in chains)
