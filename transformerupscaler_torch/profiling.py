"""Profiling: the stream pipeline's per-frame spans, the port's counters, and
a ``torch.profiler`` trace (JAX counterpart of ``trace``:
transformerupscaler_tpu/tools/profiling.py).

``FrameTrace`` is what a ``StreamPipeline`` records into while its ``trace``
is set (``pipe.trace = FrameTrace(capacity)``; None, the default, records
nothing). Each frame gets one ``FrameRecord``, keyed by the frame's index:
its host spans (``SPANS``), read on ``time.perf_counter`` by the pipeline's
producer thread (the pull and the preprocess) and its main loop (the rest;
the same readings its ``StageTimer`` adds up), and on the card its
device intervals, from CUDA events the pipeline records around the frame's
copy in, graph replay and copy out, placed on the host clock by an anchor
event (``FrameTrace.on_host``). Records go into a ring of fixed capacity and
are written out only when asked (``write_chrome_trace``). While a
``torch.profiler`` session is active, each host span is also a
``record_function`` range of the same name, each turn of the pipeline's main
loop (from one take of a frame to the next) a range ``pipeline.loop``, and
the resolution of a frame's events a range ``pipeline.resolve``
(``profiler.first_resolve`` for the first in a session, which holds the
profiler's start-up), so the program's names sit in the profiler's trace
beside the kernels and cover the loop's host time. A session records only
the thread that started it, so the producer's spans are in the records
alone; the main loop's take of the next frame, where it waits for the
producer, is the range ``pipeline.preprocess_wait`` whether or not a trace
is set (``profiler_range``).

``COUNTERS`` are the port's counters (``counters``), re-exported here.

``trace(logdir)`` is a ``torch.profiler`` context over the CPU and, where a
GPU is visible, CUDA, whose Chrome trace is written to ``logdir/trace.json``
on exit (``train --traceback``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

from transformerupscaler_torch.counters import COUNTERS  # noqa: F401

# Every span a frame's record may hold, with its parent. The device
# intervals lie between the frame's four CUDA events (before the copy in,
# after it, after the replay, after the copy out).
SPANS = {
    "pipeline.frame": None,
    "pipeline.pull": "pipeline.frame",
    "pipeline.preprocess": "pipeline.frame",
    "pipeline.preprocess_wait": "pipeline.frame",
    "pipeline.dispatch": "pipeline.frame",
    "pipeline.slot_wait": "pipeline.dispatch",
    "pipeline.stage_in": "pipeline.dispatch",
    "pipeline.enqueue": "pipeline.dispatch",
    "pipeline.fetch": "pipeline.frame",
    "pipeline.fetch_wait": "pipeline.fetch",
    "pipeline.copy_out": "pipeline.fetch",
    "pipeline.sink": "pipeline.frame",
    "device.copy_in": "pipeline.frame",
    "device.graph": "pipeline.frame",
    "device.copy_out": "pipeline.frame",
}
DEVICE_SPANS = ("device.copy_in", "device.graph", "device.copy_out")
# The spans the pipeline's producer thread records.
PRODUCER_SPANS = ("pipeline.pull", "pipeline.preprocess")
# Re-anchor once the anchor has drifted this far from the host clock, or
# has aged this long (``elapsed_time`` is a float32 count of ms: 4 us a
# step at 60 s); probe at most this often.
REANCHOR_S = 50e-6
ANCHOR_AGE_S = 30.0
PROBE_S = 1.0
_NO_RANGE = contextlib.nullcontext()
# PyTorch's C++ range (a microsecond where ``record_function`` takes ten).
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def profiler_range(name: str):
    """A profiler range while a session is active (a range costs
    microseconds even when none is), else a no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _Range(name)
    return _NO_RANGE


class Span(NamedTuple):
    name: str
    start: float  # seconds on time.perf_counter
    end: float
    frame: int
    parent: str | None
    tid: int | None  # the host thread's native id; None on the device


class FrameRecord:
    """One frame's spans: ``times`` maps a name of ``SPANS`` to its (start,
    end) on ``time.perf_counter``. ``events`` holds the frame's CUDA events
    from its dispatch until the frame has left the sink. Made on the
    producer thread (``worker_tid``), which records ``PRODUCER_SPANS``; the
    main loop records the rest from its take on (``tid``)."""

    __slots__ = ("trace", "n", "times", "tid", "worker_tid", "events",
                 "new_array")

    def __init__(self, trace: FrameTrace, n: int):
        self.trace = trace
        self.n = n
        self.times: dict[str, tuple[float, float]] = {}
        self.tid = None
        self.worker_tid = threading.current_thread().native_id
        self.events = None
        self.new_array = False

    def timed(self, name: str, fn, *args):
        """``fn(*args)`` as the span ``name``: returns its result and the two
        readings around it."""
        with profiler_range(name):
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
        self.times[name] = (t0, t1)
        return out, t0, t1

    def taken(self, t0: float, t1: float):
        """The main loop took the frame: its wait from ``t0`` to ``t1`` is
        the span ``pipeline.preprocess_wait``, on the main thread."""
        self.tid = threading.current_thread().native_id
        self.times["pipeline.preprocess_wait"] = (t0, t1)

    def spans(self) -> list[Span]:
        out = []
        for name, parent in SPANS.items():
            if name in self.times:
                tid = (None if name.startswith("device.") else
                       self.worker_tid if name in PRODUCER_SPANS
                       else self.tid)
                out.append(Span(name, *self.times[name], self.n, parent, tid))
        return out


class FrameTrace:
    """A ring of the last ``capacity`` frames' records, and the anchor that
    puts the card's events on the host clock."""

    def __init__(self, capacity: int = 4096):
        self.frames: collections.deque[FrameRecord] = collections.deque(
            maxlen=capacity)
        self.anchor = None  # (event, perf_counter seconds)
        self.origin = None  # the first anchor, for the drift
        # (seconds since the first anchor, drift in seconds) a probe
        self.drift: collections.deque[tuple[float, float]] = \
            collections.deque(maxlen=capacity)
        self.reanchored = 0
        self._stream = None
        self._probed = 0.0
        self._loop = None  # the open ``pipeline.loop`` range
        self._profiled = False  # a profiler session at the last resolution

    def attach(self, device: torch.device):
        """Called by the pipeline this trace is set on: on the card, anchor
        the device's clock to the host's."""
        if device.type == "cuda" and self.anchor is None:
            self._stream = torch.cuda.Stream(device)
            torch.cuda.synchronize(device)
            self.anchor = self.origin = self._mark()
            self._probed = self.anchor[1]

    def _mark(self):
        """An event recorded on the trace's own idle stream and the host
        time it was recorded at."""
        e = torch.cuda.Event(enable_timing=True)
        e.record(self._stream)
        return e, time.perf_counter()

    def on_host(self, event: torch.cuda.Event) -> float:
        """A completed event's time on ``time.perf_counter``."""
        a, t = self.anchor
        return t + a.elapsed_time(event) * 1e-3

    def pull(self, src, n: int):
        """``next(src, None)`` as frame ``n``'s span ``pipeline.pull``, on
        the pipeline's producer thread: (its new record, the frame, the two
        readings)."""
        rec = FrameRecord(self, n)
        frame, t0, t1 = rec.timed("pipeline.pull", next, src, None)
        return rec, frame, t0, t1

    def turn(self):
        """Ends the main loop's last turn and starts the next (at each take
        of a frame)."""
        self.close_loop()
        if _autograd_profiler._is_profiler_enabled:
            self._loop = _Range("pipeline.loop")
            self._loop.__enter__()

    def close_loop(self):
        """End the loop's open turn (the pipeline's run ends)."""
        if self._loop is not None:
            self._loop.__exit__(None, None, None)
            self._loop = None

    def _resolve(self, rec: FrameRecord):
        """The frame's device intervals as host times (its last event
        completed before its fetch's copy out); the events are dropped.
        Every ``PROBE_S`` seconds, once the pipeline's stream is idle, the
        anchor's drift is measured by an event on the trace's own stream,
        and the anchor moves to that event when it has drifted past
        ``REANCHOR_S`` or aged past ``ANCHOR_AGE_S``."""
        at = [self.on_host(e) for e in rec.events]
        rec.events = None
        for name, start, end in zip(DEVICE_SPANS, at, at[1:]):
            rec.times[name] = (start, end)
        if at[-1] - self._probed >= PROBE_S and torch.cuda.current_stream(
                self._stream.device).query():
            self._probe()

    def _probe(self):
        e, t = self._mark()
        self._probed = t
        e.synchronize()
        o, t0 = self.origin
        self.drift.append((t - t0, t0 + o.elapsed_time(e) * 1e-3 - t))
        if (abs(self.on_host(e) - t) > REANCHOR_S
                or t - self.anchor[1] > ANCHOR_AGE_S):
            self.anchor = (e, t)
            self.reanchored += 1

    def end(self, rec: FrameRecord, t: float):
        """The frame left the sink at ``t``: its events are resolved, off
        its way to the sink, and its record goes into the ring."""
        rec.times["pipeline.frame"] = (rec.times["pipeline.pull"][0], t)
        if rec.events is not None:
            with profiler_range(self._resolve_range()):
                self._resolve(rec)
        self.frames.append(rec)

    def _resolve_range(self) -> str:
        """The name of the profiler range around a frame's resolution:
        ``profiler.first_resolve`` for the first after a profiler session
        opens, whose first CUDA call waits out the profiler's start-up
        (milliseconds, for CUPTI's buffers: the profiler's cost, not the
        program's), else ``pipeline.resolve``."""
        on = _autograd_profiler._is_profiler_enabled
        first, self._profiled = on and not self._profiled, on
        return "profiler.first_resolve" if first else "pipeline.resolve"

    def write_chrome_trace(self, path: str):
        """The ring's frames as a Chrome trace (``chrome://tracing``,
        Perfetto) in ``path``, times in microseconds on
        ``time.perf_counter``: host spans as complete events on their
        threads, each frame's ``pipeline.frame`` as an async span (three
        frames are in flight at once), the device intervals on a track of
        their own."""
        pid, dev = os.getpid(), 0
        events = [dict(ph="M", name="process_name", pid=pid,
                       args=dict(name="host")),
                  dict(ph="M", name="process_name", pid=dev, tid=0,
                       args=dict(name="device")),
                  dict(ph="M", name="thread_name", pid=dev, tid=0,
                       args=dict(name="stream"))]
        for rec in self.frames:
            for s in rec.spans():
                ts, dur = s.start * 1e6, (s.end - s.start) * 1e6
                args = dict(frame=s.frame, parent=s.parent)
                if s.name == "pipeline.frame":
                    for ph, t in (("b", ts), ("e", ts + dur)):
                        events.append(dict(ph=ph, cat="frame", id=s.frame,
                                           name=s.name, ts=t, pid=pid,
                                           tid=s.tid, args=args))
                else:
                    events.append(dict(
                        ph="X", name=s.name, ts=ts, dur=dur, args=args,
                        pid=dev if s.tid is None else pid,
                        tid=0 if s.tid is None else s.tid))
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a GPU is
    visible), written as ``logdir/trace.json`` when the block ends
    (default ``logdir``: ``tux_trace`` in the temporary directory). Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "tux_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
