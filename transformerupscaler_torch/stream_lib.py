"""Streaming upscale pipeline (JAX counterpart:
transformerupscaler_tpu/stream_lib.py:31-221).

The headless core of the live overlay: frames come from a source, are
pulled and preprocessed one frame ahead on a producer thread, upscaled and
quantized back to uint8 on the device, and handed to a sink, with at most
two frames in flight: a frame is retired as soon as no next frame is
waiting, and behind the next frame's dispatch when one is (``run``). Every
frame of the source is delivered, where JAX's pipeline drops the last.
``stream``, ``overlay`` and ``app_overlay`` are its frontends.

On the card the step, from a static uint8 input frame to a static uint8
output frame (normalize, the model, the optional RGB->BGR flip, the clip
and the cast), runs as one CUDA graph (``infer_lib.CapturedForward``). The
host holds two pinned input slots and two pinned output slots. Frame i's
host-to-device copy, its replay and its device-to-host copy are enqueued in
that order on one stream, and an event is recorded after each copy; frame i
may be dispatched before frame i-1 is fetched, never before frame i-2 is,
and a fetch waits on its output slot's event and copies the frame out of
the pinned slot. So:

- replay i+1 cannot overwrite the static output before frame i's copy out
  has read it: the copy is enqueued before the replay, on the same stream;
- the copies are asynchronous because their host memory is pinned (a
  ``non_blocking`` copy from pageable memory is synchronous);
- the host refills a pinned input slot only after that slot's last copy
  has completed (its event), and an output slot is read only after its
  copy has completed and before the next copy into it is enqueued.

Each output frame is a numpy array of its own, as the JAX pipeline's are;
an array the sink has let go of (no reference left but the pipeline's) is
reused for a later frame rather than a new one allocated.

With ``pipe.trace = profiling.FrameTrace(capacity)`` each frame's host
spans and, on the card, its device intervals are recorded
(``profiling``); with ``pipe.trace`` None, the default, the loop tests
that once a stage and records nothing.

With ``device="cpu"`` the step runs eagerly, with the same stages and the
same frames; ``step`` runs it eagerly on the card too, to compare with.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from transformerupscaler_torch import native, profiling
from transformerupscaler_torch.checkpoint import load_latest_params
from transformerupscaler_torch.counters import COUNTERS
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.infer_lib import CapturedForward
from transformerupscaler_torch.ops.quant import quantize_linear_params
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

STAGES = ("capture", "preprocess", "inference", "postprocess", "display")
# Output frames the pipeline keeps to reuse once the sink has let go.
HANDED = 3


class StageTimer:
    """Per-stage wall-clock totals and their report (JAX stream_lib.py:31-51,
    the same text)."""

    def __init__(self, stages):
        self.totals = {s: 0.0 for s in stages}
        self.iterations = 0

    def add(self, stage: str, dt: float):
        self.totals[stage] += dt

    def report(self) -> str:
        lines = []
        it = max(self.iterations, 1)
        for step, total in self.totals.items():
            lines.append(f"{step}: total = {total:.4f} sec, "
                         f"average per iteration = {total / it:.4f} sec")
        max_step = max(self.totals, key=lambda k: self.totals[k])
        lines.append(f"Step that took the most time on average: {max_step} "
                     f"({self.totals[max_step] / it:.4f} sec per iteration)")
        return "\n".join(lines)


class StreamPipeline:
    """Upscale a stream of HWC uint8 frames of any size to ``res_out`` uint8
    frames (RGB, or BGR with ``bgr_out``).

    The arguments are JAX's (stream_lib.py:54-92), plus ``device`` (None:
    the card) and ``config`` (further model fields, such as narrower
    widths). Weights: ``params`` (a JAX tree) if given, else the latest
    checkpoint unless ``load_checkpoint`` is False (``from_checkpoint`` says
    which), else ``seeded_params(model, 0)``; ``quantize`` int8 round-trips
    their linear kernels.
    ``int8_serve`` implies ``compose_tails``; ``serve_quality`` applies to
    FastTransformer only and is dropped for the other models."""

    def __init__(self, model_name: str, res_in: tuple[int, int],
                 res_out: tuple[int, int], params=None, dtype=torch.bfloat16,
                 attn_impl: str = "xla", quantize: bool = False,
                 compose_tails: bool = False,
                 checkpoint_dir: str | None = None, bgr_out: bool = False,
                 load_checkpoint: bool = True, int8_mlp: bool = False,
                 pallas_serve: bool = False, packed_serve: bool = False,
                 int8_serve: bool = False, int8_scope: str = "full",
                 int8_trunk: bool = False, serve_quality: bool = False,
                 device=None, config: dict | None = None):
        self.device = resolve_device(device)
        compose_tails = compose_tails or int8_serve
        serve_quality = serve_quality and model_name == "FastTransformer"
        extra = {"serve_quality": True} if serve_quality else {}
        self.model = get_model(model_name, device=self.device, dtype=dtype,
                               attn_impl=attn_impl,
                               compose_tails=compose_tails,
                               int8_mlp=int8_mlp, pallas_serve=pallas_serve,
                               packed_serve=packed_serve,
                               int8_serve=int8_serve, int8_scope=int8_scope,
                               int8_trunk=int8_trunk, **extra,
                               **(config or {}))
        self.model_name = model_name
        self.res_in = tuple(res_in)
        self.res_out = tuple(res_out)
        self.dtype = dtype
        self.bgr_out = bgr_out
        if params is None and load_checkpoint:
            params = load_latest_params(model_name, checkpoint_dir)
        self.from_checkpoint = params is not None
        if params is None:
            params = seeded_params(self.model, 0)
        if quantize:
            params = quantize_linear_params(params)
        self.params = params
        params_from_jax(self.model, params)
        # serve_quality reads the frame in f32 (its exact conv1 and f32
        # boundaries), as the JAX step normalizes it.
        self.in_dtype = torch.float32 if serve_quality else dtype
        # JAX's jitted step divides by 255 as a product with the f32
        # reciprocal, then rounds to the input dtype.
        self._inv255 = torch.full((), np.float32(1.0 / 255.0),
                                  dtype=torch.float32, device=self.device)
        self.cuda_graphs = self.device.type == "cuda"
        self._graph = None
        self._trace = None
        self.timer = StageTimer(STAGES)

    @property
    def trace(self) -> profiling.FrameTrace | None:
        """Where each frame's spans are recorded (``profiling.FrameTrace``),
        or None: no span, no event beyond the two a frame the pipeline
        needs. Setting a trace anchors the card's clock to the host's."""
        return self._trace

    @trace.setter
    def trace(self, trace: profiling.FrameTrace | None):
        if trace is not None:
            trace.attach(self.device)
        self._trace = trace

    def _step(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """HWC uint8 frame on the device -> HWC uint8 ``res_out`` frame, with
        the rounding points of JAX's jitted step (stream_lib.py:102-114):
        the frame normalized as f32(frame) * f32(1 / 255) rounded to the
        input dtype (XLA's form of the division by 255), the model, the
        flip, then clip(out * 255 + 0.5, 0, 255) in the dtype the model
        returns, truncated to uint8."""
        x = (frame_u8.to(torch.float32) * self._inv255).to(self.in_dtype)
        kwargs = {"res_out": self.res_out}
        if self.model_name != "BicubicInterpolation":
            kwargs["require_ratio"] = True
        out = self.model(x[None], **kwargs)[0]
        if self.bgr_out:
            out = out.flip(-1)
        return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8)

    def step(self, frame: np.ndarray) -> np.ndarray:
        """One frame of ``res_in`` through the eager step (no graph, no
        pinned slots): the frame the pipeline must give for it."""
        x = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        return self._step(x).cpu().numpy()

    def _capture(self) -> CapturedForward:
        if self._graph is None:
            frame = torch.zeros(*self.res_in, 3, dtype=torch.uint8,
                                device=self.device)
            self._graph = CapturedForward(self._step, frame,
                                          what=f"the {self.model_name} "
                                               f"stream step")
            pin = dict(dtype=torch.uint8, pin_memory=True)
            self._host_in = [torch.empty(*self.res_in, 3, **pin)
                             for _ in range(2)]
            self._host_out = [torch.empty(*self._graph.out.shape, **pin)
                              for _ in range(2)]
            self._in_done = [None, None]
            self._out_done = [None, None]
            self._marks = [None, None]
            self._handed = []
        return self._graph

    def warmup(self) -> float:
        """Build the step ahead of use (on the card: capture its graph, the
        kernels built on the way); returns the seconds."""
        t0 = time.perf_counter()
        if self.cuda_graphs:
            self._capture().replay()
            torch.cuda.synchronize(self.device)
        else:
            self.step(np.zeros((*self.res_in, 3), np.uint8))
        return time.perf_counter() - t0

    def _dispatch(self, frame: np.ndarray, slot: int, rec=None):
        """Enqueue one preprocessed frame; returns its handle for
        ``_fetch``. ``rec``: the frame's ``profiling.FrameRecord``, or
        None."""
        if not self.cuda_graphs:
            return self._step(torch.from_numpy(frame).to(self.device))
        g = self._capture()
        COUNTERS["bytes_in"] += self._host_in[slot].nbytes
        if rec is not None:
            rec.timed("pipeline.slot_wait", self._slot_wait, slot)
            rec.timed("pipeline.stage_in", self._stage_in, frame, slot)
            if self._marks[slot] is None:
                self._marks[slot] = [torch.cuda.Event(enable_timing=True)
                                     for _ in range(4)]
            rec.events = self._marks[slot]
            rec.timed("pipeline.enqueue", self._enqueue, g, slot, rec.events)
            return slot
        self._slot_wait(slot)
        self._stage_in(frame, slot)
        self._enqueue(g, slot)
        return slot

    def _slot_wait(self, slot: int):
        """Wait until the slot's last copy in has read its pinned input."""
        if self._in_done[slot] is not None:
            self._in_done[slot].synchronize()

    def _stage_in(self, frame: np.ndarray, slot: int):
        self._host_in[slot].numpy()[...] = frame

    def _enqueue(self, g: CapturedForward, slot: int, marks=None):
        """The copy in, the replay and the copy out, with the slot's
        ``_in_done`` recorded after the copy in and its ``_out_done`` after
        the copy out: two new events, or a traced frame's four timing
        ``marks`` (the slot keeps them for its next traced frame: this
        frame's are resolved once it has left the sink, before the slot is
        dispatched again), which add one before the copy in and one after
        the replay."""
        if marks is None:
            self._in_done[slot] = torch.cuda.Event()
            self._out_done[slot] = torch.cuda.Event()
        else:
            marks[0].record()
            self._in_done[slot], self._out_done[slot] = marks[1], marks[3]
        g.static_in.copy_(self._host_in[slot], non_blocking=True)
        self._in_done[slot].record()
        g.replay()
        if marks is not None:
            marks[2].record()
        self._host_out[slot].copy_(g.out, non_blocking=True)
        self._out_done[slot].record()

    def _fetch(self, handle, rec=None) -> np.ndarray:
        """The frame of a dispatch, on the host, waiting for it: copied out
        of its pinned slot into a frame array of its own. ``rec``: the
        frame's ``profiling.FrameRecord``, or None."""
        if not self.cuda_graphs:
            return np.asarray(handle)
        if rec is not None:
            rec.timed("pipeline.fetch_wait",
                      self._out_done[handle].synchronize)
            made = COUNTERS["new_frame_arrays"]
            out = rec.timed("pipeline.copy_out", self._copy_out, handle)[0]
            rec.new_array = COUNTERS["new_frame_arrays"] != made
            return out
        self._out_done[handle].synchronize()
        return self._copy_out(handle)

    def _copy_out(self, handle) -> np.ndarray:
        out = self._frame_array()
        np.copyto(out, self._host_out[handle].numpy())
        COUNTERS["bytes_out"] += out.nbytes
        return out

    def _frame_array(self) -> np.ndarray:
        """An array for the next output frame: one handed out before that
        nobody but the pipeline holds any more, else a new one. (A new
        6.2 MB array faults in its pages as it is first written, ~1500 page
        faults a 1080p frame, which cost milliseconds where faults are
        slow.) The pipeline keeps the last few frames it handed out; a
        frame the sink still holds is never reused."""
        for i in range(len(self._handed)):
            if sys.getrefcount(self._handed[i]) == 2:  # the list's, the call's
                out = self._handed.pop(i)
                break
        else:
            out = np.empty(self._host_out[0].shape, np.uint8)
            COUNTERS["new_frame_arrays"] += 1
        self._handed = self._handed[-(HANDED - 1):] + [out]
        return out

    def run(self, source, sink=None, max_frames: int | None = None,
            preprocess=None) -> dict:
        """Drive the pipeline, frame i+1 dispatched before frame i is
        fetched wherever it is already waiting (JAX stream_lib.py:126-221,
        the same stages and result).

        source: an iterator of HWC uint8 frames of any size; preprocess
        defaults to the native resize to ``res_in`` of a frame of another
        size; sink: a callable taking each output frame, or None;
        max_frames: at most this many frames are pulled. A source of n
        frames gives n, in order (JAX's pipeline gives n - 1: it dispatches
        a frame only once the next one is pulled, so its last is never
        dispatched).

        A producer thread pulls each frame and preprocesses it, at most one
        frame ahead of the dispatch; the main thread takes it, dispatches
        it, fetches it and hands it to the sink. Before each take, a frame
        still in flight is retired at once if no next frame is waiting: the
        producer, once it has begun the next pull, is blocked in the source
        with nothing ready (a live source: the frame is not held until the
        next one is due; ``COUNTERS["frames_retired_alone"]``). Otherwise
        the next frame is dispatched first and the one in flight retired
        after it (a source that keeps up: host and device overlap;
        ``COUNTERS["frames_retired_behind"]``). An exception in the source
        or the preprocess is raised here; once the run ends or raises, the
        producer pulls no further frame.

        Stages: capture, the producer's pull from the source; preprocess,
        the main thread's wait to take the next frame; inference, from
        frame i's dispatch to its fetch (device latency with the copies;
        host work overlaps it, so the stages may sum past the wall clock);
        postprocess, the time blocked in the fetch; display, the sink.

        With a ``trace`` set, each stage's two readings are also its span in
        the frame's record (capture: ``pipeline.pull``, and the preprocess
        itself ``pipeline.preprocess``, on the producer's thread;
        preprocess: ``pipeline.preprocess_wait``; postprocess:
        ``pipeline.fetch``; display: ``pipeline.sink``; inference: from
        ``pipeline.dispatch``'s start to ``pipeline.fetch``'s end). The
        trace is read at every frame's pull, so it may be set or cleared
        while the pipeline runs (frames pulled while it was set finish
        their records).

        Returns {"frames", "wall_s", "fps", "report"}."""

        def default_preprocess(frame):
            if frame.shape[:2] != self.res_in:
                frame = native.resize_bilinear_u8(frame, self.res_in)
            return np.ascontiguousarray(frame, dtype=np.uint8)

        preprocess = preprocess or default_preprocess
        if sink is None:
            sink = lambda frame: None  # noqa: E731
        timer = self.timer
        src = iter(source)

        def pull(k):
            trace = self._trace
            if trace is None:
                t0 = time.perf_counter()
                frame = next(src, None)
                t1 = time.perf_counter()
                rec = None
            else:
                rec, frame, t0, t1 = trace.pull(src, k)
            if frame is not None:
                timer.add("capture", t1 - t0)
            return frame, rec

        def prepare(frame, rec):
            if rec is None:
                return preprocess(frame), None
            return rec.timed("pipeline.preprocess", preprocess, frame)[0], rec

        def finish(pending, alone):
            handle, t_dispatch, rec = pending
            COUNTERS["frames_retired_alone" if alone
                     else "frames_retired_behind"] += 1
            if rec is None:
                t0 = time.perf_counter()
                out_np = self._fetch(handle)
                t1 = t2 = time.perf_counter()
                sink(out_np)
                t3 = time.perf_counter()
            else:
                out_np, t0, t1 = rec.timed("pipeline.fetch", self._fetch,
                                           handle, rec)
                _, t2, t3 = rec.timed("pipeline.sink", sink, out_np)
                rec.trace.end(rec, t3)
            timer.add("postprocess", t1 - t0)
            timer.add("inference", t1 - t_dispatch)
            timer.add("display", t3 - t2)
            timer.iterations += 1

        pending = None  # (handle, dispatch time, record): the frame in flight
        looped = None  # the trace whose ``pipeline.loop`` range is open
        n = 0
        t_loop = time.perf_counter()
        producer = _Producer(pull, prepare, max_frames)
        try:
            while True:
                if pending is not None and not producer.waiting():
                    finish(pending, alone=True)
                    pending = None
                trace = self._trace
                if looped is not None and looped is not trace:
                    looped.close_loop()
                looped = trace
                if trace is not None:
                    trace.turn()
                with profiling.profiler_range("pipeline.preprocess_wait"):
                    t0 = time.perf_counter()
                    item = producer.take()
                    t1 = time.perf_counter()
                if item is None:
                    break
                timer.add("preprocess", t1 - t0)
                frame, rec = item
                if rec is None:
                    t_dispatch = time.perf_counter()
                    handle = self._dispatch(frame, n % 2)
                else:
                    rec.taken(t0, t1)
                    handle, t_dispatch, _ = rec.timed(
                        "pipeline.dispatch", self._dispatch, frame, n % 2,
                        rec)
                if pending is not None:
                    finish(pending, alone=False)
                pending = (handle, t_dispatch, rec)
                n += 1
            if pending is not None:
                finish(pending, alone=True)
        finally:
            producer.stop()
            if looped is not None:
                looped.close_loop()

        wall = time.perf_counter() - t_loop
        return {
            "frames": n,
            "wall_s": wall,
            "fps": n / wall if wall > 0 else 0.0,
            "report": self.timer.report(),
        }


class _Producer:
    """The pipeline's producer thread: ``pull(k)`` gives frame k of the
    source and its record (the frame None at the source's end), and
    ``prepare(frame, record)`` preprocesses it. Frame k is pulled only once
    the main thread has taken frame k - 1, so one frame at most is ahead of
    the dispatch; at most ``max_frames`` are pulled. An exception raised
    here is raised again by ``take``."""

    def __init__(self, pull, prepare, max_frames: int | None):
        self._pull, self._prepare, self._max = pull, prepare, max_frames
        self._ready = queue.SimpleQueue()  # (frame, record), _Failed or None
        self._cv = threading.Condition()
        self._taken = 0  # frames the main thread took
        self._started = 0  # pulls begun
        self._in_source = False  # blocked in the source's next()
        self._ended = self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="StreamPipeline.producer")
        self._thread.start()

    def _run(self):
        k = 0
        try:
            while self._max is None or k < self._max:
                with self._cv:
                    self._cv.wait_for(
                        lambda: self._taken >= k or self._stopped)
                    if self._stopped:
                        return
                    self._started, self._in_source = k + 1, True
                    self._cv.notify_all()
                frame, rec = self._pull(k)
                self._in_source = False
                if frame is None:
                    break
                self._ready.put(self._prepare(frame, rec))
                k += 1
            self._ready.put(None)
        except BaseException as e:
            self._ready.put(_Failed(e))
        finally:
            with self._cv:
                self._ended = True
                self._cv.notify_all()

    def waiting(self) -> bool:
        """Whether the next frame is on its way: waits until the producer
        has begun the pull after the last take (or ended), then False only
        while it is blocked in the source with nothing ready."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._started > self._taken or self._ended)
            return not (self._in_source and self._ready.empty())

    def take(self):
        """The next (frame, record), None at the source's end, waiting for
        it; the producer may then pull the one after."""
        item = self._ready.get()
        with self._cv:
            self._taken += 1
            self._cv.notify_all()
        if isinstance(item, _Failed):
            raise item.error
        return item

    def stop(self):
        """No further pull; returns once the thread has ended."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join()


class _Failed:
    """An exception raised on the producer thread, for the main thread."""

    def __init__(self, error: BaseException):
        self.error = error
