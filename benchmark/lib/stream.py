"""The stream cells: ``StreamPipeline.run`` of the port, fed from a ring of
seeded frames closed loop (as fast as it takes them) or open loop (frame j
due at t0 + j / rate, whether or not the pipeline kept up).

The sink records when each frame arrives; frame k at the sink is source
frame k (the pipeline keeps the order). A seeded sample of the frames of
the window is kept and compared with the plain reference once the window
has closed and the pipeline is freed.

In the traced run the window's last ``TRACE_LEN_S`` seconds (a quarter of
a shorter window) are profiled. The profiler slows the host (its CUDA
activity makes each graph launch slower), and these cells are paced by the
host, so the program's spans, the CUDA events around each frame's device
work and the frame rate a per-layer metric reads are taken over the
window's part before that slice (``part``); the slice gives the kernels'
device times and the breakdown. The untraced run's part is its whole
window.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.lib import check, trace
from benchmark.lib.weights import load_flat, tree

TRACE_LEN_S = 2.0


def seed_rng(seed: int, salt: int = 0) -> np.random.Generator:
    """A numpy generator for any whole ``seed`` (negative or past 64 bits
    too), one stream per ``salt``."""
    return np.random.default_rng([abs(seed), int(seed < 0), salt])


def make_frames(seed: int, hw, n: int, device) -> list[np.ndarray]:
    """``n`` HWC uint8 frames of ``hw``, made on ``device`` from ``seed`` in
    a few calls and brought to the host (the pipeline's input): a smooth
    image (bicubic of a coarse random grid, 1/32 of the size) with grain
    (std 10 of 255), so that the model sees both edges and flat regions."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device)
    g.manual_seed(seed & (2 ** 64 - 1))
    h, w = hw
    coarse = torch.rand((n, 3, h // 32 + 2, w // 32 + 2), generator=g,
                        device=device)
    img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                        align_corners=False)
    img += torch.randn(img.shape, generator=g, device=device) * (10 / 255)
    img = (img.clamp_(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    out = img.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return [out[i] for i in range(n)]


def build_pipeline(cfg: dict, traffic: dict, flat: dict, device,
                   flags: dict | None = None):
    """The port's pipeline as its stream CLI builds it for the config's
    serving flags (``cli.serve_flags`` on the card), with the config's
    widths and the committed weights; ``flags`` replaces the config's
    serving flags (the control's int8)."""
    import torch

    from transformerupscaler_torch.cli import serve_flags
    from transformerupscaler_torch.stream_lib import StreamPipeline

    sf = dict(cfg["serve_flags"], **(flags or {}))
    return StreamPipeline(
        cfg["model"], tuple(traffic["res_in"]), tuple(traffic["res_out"]),
        params=tree(flat), dtype=getattr(torch, cfg["dtype"]),
        bgr_out=bool(traffic.get("bgr_out", False)), device=device,
        config=dict(cfg["fields"]),
        **serve_flags(sf["fast"], sf["quality"], sf.get("int8", "off"),
                      card=device.type == "cuda"))


class Recorder:
    """The sink: arrival times, the window's bookkeeping, the kept sample
    and, in the traced run, the traced slice and the replay events.

    ``preroll``: the closed loop's window opens at the sink's preroll-th
    frame; the open loop's source opens it at its first frame's due time
    and sets ``due`` and ``window_index``."""

    def __init__(self, pipe, seconds: float, sample: int, seed: int,
                 traced: bool, preroll: int | None = None):
        from transformerupscaler_torch.kernels._common import launch_counts

        self.launch_counts = launch_counts
        self.pipe = pipe
        self.seconds = seconds
        self.traced = traced
        self.preroll = preroll
        self.arrivals: list[float] = []
        self.t_w0 = self.t_end = self.t_part = None
        self.due = None
        self.window_index = None
        self.kept: list[tuple[int, np.ndarray]] = []
        self.rng = seed_rng(seed, 2)
        # The sample's frames are copied into arrays made now (and written
        # once, so that no page faults in the window), not held: a held
        # frame would make the pipeline allocate a new one.
        shape = (*pipe.res_out, 3)
        self.buffers = [np.ones(shape, np.uint8) for _ in range(sample)]
        self.points: list = []
        self.in_window = self.in_part = 0
        self.slice = trace.Slice() if traced else None
        self.trace_frames = 0
        self.graph_events: list = []
        self._replayed = None
        self.totals0 = self.totals1 = None
        self.launches0 = self.launches1 = None
        if traced:
            self.slice.warm()
            self._wrap_for_trace()

    def _wrap_for_trace(self):
        """CUDA events before and after each graph replay of the window's
        part and after its frame's copy out (the dispatch's last work), and
        annotations around replays and the pipeline's dispatch and fetch,
        from here (the program has no spans of its own yet)."""
        import torch

        g = self.pipe._capture()
        replay, dispatch, fetch = (g.replay, self.pipe._dispatch,
                                   self.pipe._fetch)

        def timed_replay():
            with trace.annotate("benchmark.replay"):
                now = time.perf_counter()
                if self.slice.prof is not None:
                    self.trace_frames += 1
                if self.t_w0 is None or not self.t_w0 <= now < self.t_part:
                    return replay()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = replay()
                e1.record()
                self._replayed = (e0, e1)
                return out

        def traced_dispatch(*a):
            with trace.annotate("benchmark.dispatch"):
                out = dispatch(*a)
            if self._replayed is not None:
                e2 = torch.cuda.Event(enable_timing=True)
                e2.record()
                self.graph_events.append((*self._replayed, e2))
                self._replayed = None
            return out

        def traced_fetch(*a):
            with trace.annotate("benchmark.fetch"):
                return fetch(*a)

        g.replay = timed_replay
        self.pipe._dispatch = traced_dispatch
        self.pipe._fetch = traced_fetch

    def start_window(self, t: float):
        self.t_w0, self.t_end = t, t + self.seconds
        self.t_part = self.t_end - (min(TRACE_LEN_S, 0.25 * self.seconds)
                                    if self.traced else 0.0)
        self.totals0 = self.totals1 = dict(self.pipe.timer.totals)
        self.launches0 = self.launches1 = self.launch_counts()
        n = len(self.buffers)
        if self.window_index is not None:  # frame indices
            first, last = self.window_index
            self.points = sorted(first + self.rng.choice(
                last - first + 1, size=min(n, last - first + 1),
                replace=False))
        else:  # times: the first frame at the sink at or after each
            self.points = sorted(t + self.rng.random(n) * self.seconds)

    def _in_window(self, k: int, now: float) -> bool:
        if self.window_index is not None:
            return self.window_index[0] <= k <= self.window_index[1]
        return self.t_w0 is not None and self.t_w0 < now <= self.t_end

    def _in_part(self, k: int, now: float) -> bool:
        return (self.due(k) if self.due else now) < self.t_part

    def __call__(self, frame: np.ndarray):
        """The pipeline's sink."""
        now = time.perf_counter()
        k = len(self.arrivals)
        self.arrivals.append(now)
        if self.preroll is not None and k == self.preroll - 1:
            self.start_window(now)
            return
        if not self._in_window(k, now):
            return
        self.in_window += 1
        self._keep(k, now, frame)
        if self._in_part(k, now):
            self.in_part += 1
            self.totals1 = dict(self.pipe.timer.totals)
            self.launches1 = self.launch_counts()
        elif self.slice is not None and self.slice.prof is None \
                and self.slice.events is None:
            self.slice.start()

    def _keep(self, k: int, now: float, frame: np.ndarray):
        """Copy the frame if it is the next of the seeded sample: the frames
        at ``points``, drawn when the window opened, uniformly over its
        frames (open loop) or its time (closed loop)."""
        at = k if self.window_index is not None else now
        while len(self.kept) < len(self.points) \
                and at >= self.points[len(self.kept)]:
            buf = self.buffers[len(self.kept)]
            np.copyto(buf, frame)
            self.kept.append((k, buf))

    def finish(self):
        """After the run: close the traced slice."""
        if self.slice is not None and self.slice.prof is not None:
            self.slice.stop()

    @property
    def part_seconds(self) -> float:
        return self.t_part - self.t_w0

    def stage_seconds(self, stage: str) -> float:
        return self.totals1[stage] - self.totals0[stage]

    def launches_per_frame(self) -> dict:
        return {k: (v - self.launches0[k]) / max(self.in_part, 1)
                for k, v in self.launches1.items()
                if v != self.launches0[k]}

    def graph_ms(self) -> tuple[list[float], list[float]]:
        """Each timed frame's graph replay, and its device work from the
        replay's start to the end of its copy out, in ms."""
        import torch

        torch.cuda.synchronize()
        return ([a.elapsed_time(b) for a, b, _ in self.graph_events],
                [a.elapsed_time(c) for a, _, c in self.graph_events])


def closed_source(frames, rec: Recorder):
    """Ring frames as fast as the pipeline pulls them, until the window
    (opened by the sink at its ``preroll``-th frame) closes."""
    k = 0
    while rec.t_end is None or time.perf_counter() < rec.t_end:
        yield frames[k % len(frames)]
        k += 1


class OpenSource:
    """Frame j due at t0 + j / rate, whatever the pipeline did; the window
    holds the frames due from ``preroll_s`` on for ``seconds``. The source
    goes on two frames past the window's last, so that every frame of the
    window leaves the pipeline as it does in the steady state, then
    stops."""

    def __init__(self, frames, rec: Recorder, rate: float, preroll_s: float):
        self.frames, self.rec, self.rate = frames, rec, rate
        self.preroll_s = preroll_s
        self.t0 = None
        self.lateness: list[float] = []
        self.first = int(np.ceil(preroll_s * rate))
        self.last = self.first + int(np.ceil(rec.seconds * rate)) - 1
        rec.window_index = (self.first, self.last)
        rec.due = self.due

    def due(self, j: int) -> float:
        return self.t0 + j / self.rate

    def __iter__(self):
        self.t0 = time.perf_counter() + 0.05
        for j in range(self.last + 3):
            if j == self.first:
                self.rec.start_window(self.due(j))
            wait = self.due(j) - time.perf_counter()
            if wait > 0:
                if self.rec.traced:
                    with trace.annotate("benchmark.source_wait"):
                        time.sleep(wait)
                else:
                    time.sleep(wait)
            self.lateness.append(time.perf_counter() - self.due(j))
            yield self.frames[j % len(self.frames)]

    def latencies_ms(self, part_only: bool = False) -> list[float]:
        """Each window frame's time from its due time to the sink, in ms; a
        frame that never arrived counts its time until now (it is also a
        failure: ``missing``). ``part_only``: only the frames due in the
        window's part."""
        arr, now = self.rec.arrivals, time.perf_counter()
        return [((arr[j] if j < len(arr) else now) - self.due(j)) * 1e3
                for j in range(self.first, self.last + 1)
                if not part_only or self.due(j) < self.rec.t_part]

    def missing(self) -> int:
        """The window's frames that never arrived at the sink."""
        return max(0, self.last + 1 - max(self.first, len(self.rec.arrivals)))


def run_stream(run, open_loop: bool) -> dict:
    """One run of a stream cell: set-up, the window, the reference check.
    Returns the driver's record (see ``benchmark/run.py``)."""
    cfg, traffic, args = run.cell.config, run.cell.traffic, run.args
    t = time.perf_counter()
    phases = {"imports": t - run.t_start}
    frames = make_frames(args.seed, traffic["res_in"], traffic["ring"],
                         run.device)
    if run.device.type == "cuda":
        import torch

        # The peak is the system's: the frames' making is not counted.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phases["frames"] = -t + (t := time.perf_counter())
    flat = load_flat(cfg)
    phases["weights"] = -t + (t := time.perf_counter())
    pipe = build_pipeline(cfg, traffic, flat, run.device)
    phases["model"] = -t + (t := time.perf_counter())
    pipe.warmup()
    phases["capture"] = -t + (t := time.perf_counter())
    rec = Recorder(pipe, args.seconds, traffic["check_frames"], args.seed,
                   bool(args.trace),
                   None if open_loop else traffic["preroll_frames"])
    if open_loop:
        source = OpenSource(frames, rec, traffic["rate_hz"],
                            traffic["preroll_s"])
    else:
        source = closed_source(frames, rec)
    pipe.run(source, sink=rec)
    rec.finish()
    phases["preroll"] = rec.t_w0 - t
    run.log("set-up seconds: " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in phases.items()))
    ref = run.cell.reference()
    (h, w), res_out = traffic["res_in"], traffic["res_out"]
    out = {"setup_s": rec.t_w0 - run.t_start, "seconds": args.seconds,
           "flops_per_frame": ref.flops(h, w, res_out, cfg["fields"]),
           "kernel_shapes": ref.kernel_shapes(h, w, res_out, cfg["fields"]),
           "frames": rec.in_part,
           "frames_per_s": rec.in_part / rec.part_seconds,
           "part_s": rec.part_seconds,
           "fetch_wait_s": rec.stage_seconds("postprocess"),
           "launches_per_frame": rec.launches_per_frame()}
    if open_loop:
        lat = source.latencies_ms()
        out["latencies_ms"] = lat
        out["part_latencies_ms"] = source.latencies_ms(part_only=True)
        out["attempted"] = len(lat)
        out["failed"] = source.missing()
        late = np.array(source.lateness[source.first:source.last + 1]) * 1e3
        run.log(f"generator lateness ms: median {np.median(late):.4f} "
                f"p95 {np.percentile(late, 95):.4f} max {late.max():.4f}")
    else:
        out["attempted"] = rec.in_window
        out["failed"] = 0
    if rec.slice is not None:
        out["graph_ms"], out["frame_device_ms"] = rec.graph_ms()
        out["trace"] = rec.slice.reduce() if rec.slice.events else None
        out["trace_frames"] = rec.trace_frames
        if out["trace"] is not None:
            run.log(f"frames/s: part {out['frames_per_s']:.2f}, profiled "
                    f"slice {rec.trace_frames / out['trace'].window_s:.2f} "
                    f"(the profiler's cost on the host)")
    run.log("launches per frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(out["launches_per_frame"].items())))
    run.log("stage seconds in the window's part: " + ", ".join(
        f"{s} {rec.stage_seconds(s):.4f}" for s in pipe.timer.totals))
    out["device"] = run.device_record()
    kept = rec.kept
    del pipe, rec, source
    gc.collect()
    if run.device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["checks"] = check.compare_stream(ref, cfg, traffic, flat, frames,
                                         kept, run.device)
    run.log(f"reference check {time.perf_counter() - t:.3f} s")
    return out
