"""A ``torch.profiler`` trace of a steady slice of the window, reduced to
what the metrics read: the device's busy time, kernel time by name, the
idle gaps by what the host was doing.

The trace is the profiler's Chrome trace (CPU ops and annotations, CUDA
kernels, copies and fills), written to the run's temporary directory and
deleted once read. Device activity is every event of the categories
``DEVICE_CATS``; the traced window is the span of the annotation
``WINDOW``, which ``Slice`` opens when it starts and closes when it stops.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "benchmark.traced_window"
# Idle gaps shorter than this are the launch gaps between one graph's
# kernels; they are counted as idle but not looked up on the host.
SHORT_GAP_US = 5.0
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without "void ", an anonymous namespace, its template
    arguments and its parameter list."""
    short = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", short, maxsplit=1)[0].strip() or name


class Slice:
    """Profile from ``start()`` to ``stop()`` (CPU and CUDA), then
    ``reduce()`` the trace."""

    def __init__(self):
        self.prof = None
        self.events = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self):
        """One short session in set-up: a process's first session, started
        while the host is busy, records nothing (torch 2.11 and 2.13)."""
        import torch

        with self._profile():
            torch.ones(8, device="cuda").sum().item()

    def start(self):
        import torch

        self.prof = self._profile()
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None

    def reduce(self) -> "TraceSummary":
        return TraceSummary(self.events)


class TraceSummary:
    """The reduction of one trace's events (Chrome trace "X" events, times
    in microseconds)."""

    def __init__(self, events: list[dict]):
        complete = [e for e in events if e.get("ph") == "X"
                    and "ts" in e and "dur" in e]
        marks = [e for e in complete if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError(f"the trace has no {WINDOW} annotation")
        w = marks[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.device = sorted(
            ((max(float(e["ts"]), self.t0),
              min(float(e["ts"]) + float(e["dur"]), self.t1), e["name"],
              e.get("cat"))
             for e in complete if e.get("cat") in DEVICE_CATS
             and float(e["ts"]) < self.t1
             and float(e["ts"]) + float(e["dur"]) > self.t0))
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in complete if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW)
        self._host_starts = [h[0] for h in self.host]
        self.busy, self.gaps = self._union()

    def _union(self):
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        last_end = self.t0
        for s, e, _, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > last_end:
                    gaps.append((last_end, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            last_end = max(last_end, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if self.t1 > last_end:
            gaps.append((last_end, self.t1))
        return busy, gaps

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy * 1e-6

    def kernels(self, pattern: str,
                category: str = "kernel") -> tuple[int, float]:
        """(launches, device seconds) of the kernels (or the copies, with
        ``category`` "gpu_memcpy") whose name matches the regular expression
        ``pattern``."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, name, cat in self.device
                if cat == category and rx.search(name)]
        return len(hits), sum(hits) * 1e-6

    def device_ops(self) -> list[list]:
        """The device operations that took the most time: [name, seconds]."""
        total: dict[str, float] = {}
        for s, e, name, _ in self.device:
            k = short_name(name)
            total[k] = total.get(k, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost traced host
        event around it, with its outermost one."""
        i = bisect.bisect_right(self._host_starts, t)
        inner = outer = None
        for s, e, name in reversed(self.host[max(0, i - 800):i]):
            if e >= t:
                inner = inner or name
                outer = name
        if inner is None:
            return "no traced host op"
        return inner if inner == outer else f"{outer} > {inner}"

    def idle_gaps(self) -> list[list]:
        """The idle time by what the host was doing in each gap (at its
        middle), largest first: [what, seconds]."""
        total: dict[str, float] = {}
        for s, e in self.gaps:
            what = (f"gaps under {SHORT_GAP_US:g} us between kernels"
                    if e - s < SHORT_GAP_US else self._host_at((s + e) / 2))
            total[what] = total.get(what, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:TOP]]


def annotate(name: str):
    """A ``record_function`` range: the traced run's spans, from the
    benchmark's own files."""
    import torch

    return torch.profiler.record_function(name)
