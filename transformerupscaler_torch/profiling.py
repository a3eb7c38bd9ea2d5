"""Profiling: a live stack sampler and a ``torch.profiler`` trace (JAX
counterpart: transformerupscaler_tpu/tools/profiling.py; the port keeps
its own copy).

``StackSampler`` samples a thread's Python stack every 50 ms and sums the
wall-clock time of each (depth, frame); ``traceback_display`` runs a
function under it and prints the time-ordered per-depth summary when the
function returns (the reference's tools/TracebackWindow.py without its
tkinter window). ``trace(logdir)`` is the device-side complement: a
``torch.profiler`` context over the CPU and, where a GPU is visible, CUDA,
whose Chrome trace is written to ``logdir/trace.json`` on exit.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import sys
import tempfile
import threading
import time

import torch


class StackSampler:
    """Samples a target thread's Python stack on an interval and accumulates
    per-(depth, frame) wall-clock time."""

    def __init__(self, target_thread_id: int, interval: float = 0.05):
        self.target = target_thread_id
        self.interval = interval
        # (depth, filename, lineno, func) -> cumulative seconds
        self.times: dict = collections.defaultdict(float)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._last = None

    def start(self):
        self._last = time.perf_counter()
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            time.sleep(self.interval)
            now = time.perf_counter()
            dt, self._last = now - self._last, now
            frame = sys._current_frames().get(self.target)
            stack = []
            while frame is not None:
                stack.append(frame)
                frame = frame.f_back
            for depth, f in enumerate(reversed(stack)):
                key = (depth, f.f_code.co_filename, f.f_lineno,
                       f.f_code.co_name)
                self.times[key] += dt

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=1)

    def report(self, top: int = 3) -> str:
        """Time-ordered per-depth summary (TracebackWindow.py:123-142)."""
        by_depth: dict = collections.defaultdict(list)
        for (depth, fname, lineno, func), t in list(self.times.items()):
            by_depth[depth].append((t, fname, lineno, func))
        lines = ["Stack sampling summary (cumulative seconds per frame):"]
        for depth in sorted(by_depth):
            for t, fname, lineno, func in sorted(by_depth[depth],
                                                 reverse=True)[:top]:
                lines.append(f"  depth {depth:2d}  {t:8.2f}s  "
                             f"{os.path.basename(fname)}:{lineno} {func}")
        return "\n".join(lines)


def traceback_display(fn):
    """Run ``fn`` under the stack sampler; print the summary when it
    returns."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        sampler = StackSampler(threading.get_ident()).start()
        try:
            return fn(*args, **kwargs)
        finally:
            sampler.stop()
            print(sampler.report())

    return wrapped


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
