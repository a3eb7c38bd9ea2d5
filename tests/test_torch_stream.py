"""The port's streaming pipeline (transformerupscaler_torch/stream_lib.py)
against the JAX package's (transformerupscaler_tpu/stream_lib.py) on the
CPU.

Bit for bit with JAX: the ``StageTimer`` report; the step's normalization
of all 256 levels and its postprocess of every bf16 value in [-0.2, 1.2]
(and f32 values there), each with the other end replaced by a stand-in
model, in bf16 and f32, with and without the BGR flip.

Pipeline against pipeline, frame for frame, tolerances in uint8 levels:
BicubicInterpolation f32 and FastTransformer at a small width with the JAX
pipeline's parameters carried across (f32: at most 1 level apart, where
XLA's fused resize and the port's eager one differ in a last bit on a
rounding edge; measured 1 element of 18432 in the bicubic frames), and the
trained FastTransformer in bf16 with the ``--fast`` flags of the card and
``bgr_out``, against a committed JAX fixture (the JAX pipeline with Pallas in
interpret mode): at most 4 levels and a mean under 0.15 level (measured 2
and 0.035: the bf16 routes differ from JAX by up to ~1e-2, about 3 levels,
plus the final rounding's level).

Behaviour: n frames from the source give n, in order (JAX's pipeline gives
n - 1: the port's first n - 1 are compared with JAX's, its last with its
own eager step); frames of another size go through the native resize;
``serve_quality`` reaches FastTransformer with an f32 input and is dropped
for the other models; the two frames in flight overlap host and device
stages, with a stand-in device step whose fetch blocks (as
tests/test_stream.py:77-132 proves it for JAX); a frame is retired alone
where no next frame is waiting (a paced source) and behind the next
frame's dispatch where one is (a closed loop); the producer thread's
errors reach the caller, and it stops pulling when the run ends.

Regenerate the fixture with ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_stream.py`` (~25 s).
"""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import native
from transformerupscaler_torch.counters import COUNTERS
from transformerupscaler_torch.stream_lib import StageTimer, StreamPipeline

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_port", "stream_fast_bf16.npz")
# The stream CLI's --fast on the card, as the overlays build it.
FAST_CARD = dict(compose_tails=True, packed_serve=True, pallas_serve=True,
                 attn_impl="fused2", bgr_out=True)
FIX_IN, FIX_OUT, FIX_FRAMES, FIX_SEED = (64, 128), (96, 192), 3, 11
FIX_TOL = (4, 0.15)  # uint8 levels: max, mean
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_pipeline(*args, **kwargs):
    from transformerupscaler_tpu.stream_lib import StreamPipeline as JaxPipe

    return JaxPipe(*args, **kwargs)


def _frames(n, hw, seed=0):
    return list(np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                     np.uint8))


def _run(pipe, frames, **kw):
    outs = []
    stats = pipe.run(iter(frames), sink=outs.append, **kw)
    return outs, stats


def test_stage_timer_report_is_jax_text():
    from transformerupscaler_tpu.stream_lib import StageTimer as JaxTimer

    ours, theirs = StageTimer(["a", "b", "c"]), JaxTimer(["a", "b", "c"])
    for t in (ours, theirs):
        for stage, dt in (("a", 1.0), ("b", 3.25), ("c", 0.125), ("a", 0.5)):
            t.add(stage, dt)
        t.iterations = 3
    assert ours.report() == theirs.report()
    assert StageTimer(["x"]).report() == JaxTimer(["x"]).report()


class _JaxStandIn:
    """A flax-like model for the JAX pipeline whose output is computed from
    the traced parameters (so XLA folds nothing away)."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, params, x, **kwargs):
        return self.fn(params, x)


def _both_steps(dtype, bgr, frame, jax_fn, port_fn, params):
    """The JAX pipeline's jitted step and the port's eager step on
    ``frame``, each with a stand-in model."""
    jp = _jax_pipeline("BicubicInterpolation", frame.shape[:2], (8, 8),
                       dtype=JDT[dtype], bgr_out=bgr, params={})
    jp.model = _JaxStandIn(jax_fn)
    want = np.asarray(jp._step({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(frame)))
    tp = StreamPipeline("BicubicInterpolation", frame.shape[:2], (8, 8),
                        dtype=dtype, bgr_out=bgr, params={}, device="cpu")
    tp.model = lambda x, **kw: port_fn(
        {k: torch.from_numpy(v) for k, v in params.items()}, x)
    return tp.step(frame), want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_normalization_of_every_level_is_jax(dtype):
    """The stand-in model compares the normalized frame x with ref, the
    level / 255 rounded to the dtype: it returns 0.5 where x == ref, 0.75
    above and 0.25 below, so the output frame is 128, 192 or 64. Equal
    frames, so the same normalized input on both sides (a comparison, so
    that XLA cannot contract the normalization's product into the stand-in's
    arithmetic)."""
    levels = np.arange(256, dtype=np.uint8)
    frame = np.repeat(levels[None, :, None], 3, axis=2)
    ref = torch.from_numpy(levels.astype(np.float64) / 255.0).to(dtype)
    params = {"ref": ref.float().numpy()[None, None, :, None]}
    jdt = JDT[dtype]

    def jax_fn(p, x):
        r = p["ref"].astype(jdt)
        return jnp.where(x == r, 0.5, jnp.where(x > r, 0.75, 0.25)).astype(
            jdt)

    def port_fn(p, x):
        r = p["ref"].to(dtype)
        return torch.where(x == r, 0.5, torch.where(x > r, 0.75, 0.25)).to(
            dtype)

    got, want = _both_steps(dtype, False, frame, jax_fn, port_fn, params)
    np.testing.assert_array_equal(got, want)
    assert (want == 128).mean() > 0.3 and (want != 128).any() == (
        dtype == torch.float32)  # f32: the product is not the quotient


@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_postprocess_of_the_same_output_is_jax(dtype, bgr):
    """Every bf16 value in [-0.2, 1.2] (f32: 60000 seeded values there) as
    the model's output, three channels apart: the same uint8 frame."""
    if dtype == torch.bfloat16:
        bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
        vals = bits.view(torch.bfloat16).float()
        vals = vals[torch.isfinite(vals) & (vals > -0.2) & (vals < 1.2)]
    else:
        vals = torch.from_numpy(np.random.default_rng(0).uniform(
            -0.2, 1.2, 60000).astype(np.float32))
    n = vals.numel() // 3 * 3
    out = vals[:n].reshape(1, -1, 3).numpy()
    params = {"out": out}
    jdt = JDT[dtype]
    got, want = _both_steps(
        dtype, bgr, np.zeros((2, 2, 3), np.uint8),
        lambda p, x: p["out"].astype(jdt)[None],
        lambda p, x: p["out"].to(dtype)[None], params)
    np.testing.assert_array_equal(got, want)


def test_bicubic_pipeline_frames_are_jax():
    frames = _frames(5, (32, 48))
    jp = _jax_pipeline("BicubicInterpolation", (32, 48), (64, 96),
                       dtype=jnp.float32)
    tp = StreamPipeline("BicubicInterpolation", (32, 48), (64, 96),
                        dtype=torch.float32, device="cpu")
    (want, js), (got, ts) = _run(jp, frames), _run(tp, frames)
    assert js["frames"] == len(want) == len(frames) - 1
    assert ts["frames"] == len(got) == len(frames)
    for g, w in zip(got, want):
        assert g.shape == (64, 96, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(int) - w)
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), d.mean())
    np.testing.assert_array_equal(got[-1], tp.step(frames[-1]))
    assert set(ts) == set(js) and "inference" in ts["report"]


def test_small_fast_transformer_pipeline_matches_jax():
    """FastTransformer at dim 32, one seeded parameter tree carried to both
    pipelines (f32, the exact path; then the CPU's --fast flags, the all-XLA
    packed path): at most 1 level apart, frame for frame."""
    from transformerupscaler_tpu.registry import get_model as jax_get_model
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import seeded_params

    frames = _frames(4, (32, 64), seed=1)
    tree = {"params": seeded_params(
        get_model("FastTransformer", device="cpu", **SMALL), 5)}
    for flags in ({}, dict(compose_tails=True, packed_serve=True)):
        jp = _jax_pipeline("FastTransformer", (32, 64), (48, 96),
                           dtype=jnp.float32, params=tree, **flags)
        jp.model = jax_get_model("FastTransformer", dtype=jnp.float32,
                                 **SMALL, **flags)
        tp = StreamPipeline("FastTransformer", (32, 64), (48, 96),
                            dtype=torch.float32, params=tree, device="cpu",
                            config=SMALL, **flags)
        (want, _), (got, stats) = _run(jp, frames), _run(tp, frames)
        assert len(want) == len(frames) - 1
        assert stats["frames"] == len(got) == len(frames)
        for g, w in zip(got, want):
            assert np.abs(g.astype(int) - w).max() <= 1, flags
        np.testing.assert_array_equal(got[-1], tp.step(frames[-1]))


def fixture_frames():
    return _frames(FIX_FRAMES, FIX_IN, seed=FIX_SEED)


def jax_stream_fixture() -> dict:
    """The JAX pipeline with the trained FastTransformer, bf16, the flags
    of ``FAST_CARD`` (Pallas in interpret mode on the CPU)."""
    from transformerupscaler_torch.checkpoint import (
        default_checkpoint_dir,
        fingerprint,
        get_latest_checkpoint,
    )

    path, epoch = get_latest_checkpoint(
        default_checkpoint_dir("FastTransformer"))
    jp = _jax_pipeline("FastTransformer", FIX_IN, FIX_OUT, **FAST_CARD)
    assert jp.from_checkpoint
    frames = fixture_frames()
    outs, stats = _run(jp, frames)
    return dict(frames=np.stack(frames), y=np.stack(outs),
                res_in=np.asarray(FIX_IN), res_out=np.asarray(FIX_OUT),
                epoch=np.int64(epoch), fingerprint=np.array(fingerprint(path)))


def level_errors(got, want) -> tuple[int, float]:
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    return int(d.max()), float(d.mean())


def test_trained_fast_pipeline_matches_jax_fixture():
    """The trained FastTransformer pipeline with the card's --fast flags
    (here on the kernels' plain versions) against the JAX pipeline's
    frames: the check chip_smoke.py's ``stream`` line makes on the card."""
    from transformerupscaler_torch.checkpoint import (
        default_checkpoint_dir,
        fingerprint,
        get_latest_checkpoint,
    )

    with np.load(FIXTURE) as f:
        fix = {k: f[k] for k in f.files}
    path, _ = get_latest_checkpoint(default_checkpoint_dir("FastTransformer"))
    assert str(fix["fingerprint"]) == fingerprint(path)
    np.testing.assert_array_equal(fix["frames"], np.stack(fixture_frames()))
    tp = StreamPipeline("FastTransformer", FIX_IN, FIX_OUT, device="cpu",
                        **FAST_CARD)
    assert tp.from_checkpoint and tp.dtype == torch.bfloat16
    got, stats = _run(tp, list(fix["frames"]))
    assert len(fix["y"]) == FIX_FRAMES - 1
    assert stats["frames"] == len(got) == FIX_FRAMES
    emax, emean = level_errors(np.stack(got[:-1]), fix["y"])
    assert emax <= FIX_TOL[0] and emean <= FIX_TOL[1], (emax, emean)
    np.testing.assert_array_equal(got[-1], tp.step(fix["frames"][-1]))


def test_oversized_frames_go_through_the_native_resize():
    frames = _frames(3, (64, 80), seed=2)
    tp = StreamPipeline("BicubicInterpolation", (16, 20), (32, 40),
                        dtype=torch.float32, device="cpu")
    before = native.CALLS["resize_bilinear_u8"]
    got, stats = _run(tp, frames)
    assert stats["frames"] == 3 and got[0].shape == (32, 40, 3)
    # Every frame preprocessed once, on the producer thread.
    assert native.CALLS["resize_bilinear_u8"] - before == 3
    np.testing.assert_array_equal(
        got[0], tp.step(native.resize_bilinear_u8(frames[0], (16, 20))))
    jp = _jax_pipeline("BicubicInterpolation", (16, 20), (32, 40),
                       dtype=jnp.float32)
    np.testing.assert_array_equal(got[1], _run(jp, frames)[0][1])
    np.testing.assert_array_equal(
        got[2], tp.step(native.resize_bilinear_u8(frames[2], (16, 20))))


def test_serve_quality_mode_and_its_no_op_elsewhere():
    frames = _frames(3, (16, 32), seed=2)
    tp = StreamPipeline("FastTransformer", (16, 32), (32, 64),
                        dtype=torch.bfloat16, pallas_serve=True,
                        compose_tails=True, packed_serve=True,
                        serve_quality=True, load_checkpoint=False,
                        device="cpu", config=SMALL)
    assert tp.model.serve_quality and tp.in_dtype == torch.float32
    assert not tp.from_checkpoint
    seen = []
    forward = tp.model.forward
    tp.model.forward = lambda x, **kw: (seen.append(x.dtype), forward(x, **kw))[1]
    got, stats = _run(tp, frames, max_frames=2)
    assert stats["frames"] == 2 and got[0].shape == (32, 64, 3)
    assert seen == [torch.float32] * 2
    b = StreamPipeline("BicubicInterpolation", (16, 16), (32, 32),
                       dtype=torch.float32, serve_quality=True, device="cpu")
    assert not hasattr(b.model, "serve_quality")
    assert b.in_dtype == torch.float32
    b16 = StreamPipeline("WindowTransformer", (16, 16), (32, 32),
                         serve_quality=True, load_checkpoint=False,
                         device="cpu", config=dict(transformer_dim=32,
                                                   num_window_blocks=1,
                                                   num_heads=2))
    assert b16.in_dtype == torch.bfloat16


class _Pending:
    """A stand-in device's frame: fetching it blocks until it is ready,
    like a copy back."""

    def __init__(self, ready_at):
        self.ready_at = ready_at

    def __array__(self, dtype=None, copy=None):
        dt = self.ready_at - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        return np.zeros((32, 32, 3), np.uint8)


class _StandInDevice:
    """A serial device queue in place of a 16x16 -> 32x32 CPU pipeline's
    step: frame i is ready at max(dispatch_i, ready_{i-1}) + ``d_dev``.
    ``spans``: each frame's (start, ready) on the device."""

    def __init__(self, pipe, d_dev):
        self.d_dev = d_dev
        self.free = 0.0
        self.spans = []
        pipe._step = self.step

    def step(self, frame):
        start = max(time.perf_counter(), self.free)
        self.free = start + self.d_dev
        self.spans.append((start, self.free))
        return _Pending(self.free)


def _stand_in_pipe(d_dev):
    pipe = StreamPipeline("BicubicInterpolation", (16, 16), (32, 32),
                          load_checkpoint=False, device="cpu")
    return pipe, _StandInDevice(pipe, d_dev)


def _retired(before) -> tuple[int, int]:
    return (COUNTERS["frames_retired_alone"] - before["frames_retired_alone"],
            COUNTERS["frames_retired_behind"]
            - before["frames_retired_behind"])


def test_two_in_flight_overlap_beats_serial_sum():
    """A stand-in device step models a serial device queue (ready_i =
    max(dispatch_i, ready_{i-1}) + d_dev) whose fetch blocks like a copy
    back; with capture and preprocess on the producer thread and the sink
    on the main thread, the wall clock lands well under the serial sum of
    the stages and above the device's floor."""
    d_cap, d_pre, d_dev, d_sink = 0.005, 0.020, 0.030, 0.005
    n_frames = 20
    pipe, _ = _stand_in_pipe(d_dev)

    def source():
        for _ in range(n_frames):
            time.sleep(d_cap)
            yield np.zeros((16, 16, 3), np.uint8)

    def preprocess(frame):
        time.sleep(d_pre)
        return frame

    stats = pipe.run(source(), sink=lambda out: time.sleep(d_sink),
                     preprocess=preprocess)
    assert stats["frames"] == n_frames
    serial_sum = stats["frames"] * (d_cap + d_pre + d_dev + d_sink)
    assert stats["wall_s"] < 0.75 * serial_sum, (stats["wall_s"], serial_sum)
    assert stats["wall_s"] > stats["frames"] * d_dev * 0.9
    assert pipe.timer.iterations == n_frames
    assert pipe.timer.totals["capture"] > 0.0


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **jax_stream_fixture())
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")


def test_output_frames_are_reused_only_when_let_go():
    """The card's fetch copies each frame into an array of its own; one the
    sink has let go of is reused, one it still holds (or a view of) never.
    Here the arrays alone, on a pipeline without a card."""
    pipe = StreamPipeline("BicubicInterpolation", (4, 4), (8, 8),
                          dtype=torch.float32, device="cpu")
    pipe._host_out = [torch.zeros(8, 8, 3, dtype=torch.uint8)]
    pipe._handed = []
    a = pipe._frame_array()
    b = pipe._frame_array()
    assert a is not b and a.shape == (8, 8, 3) and a.dtype == np.uint8
    a_ptr, view = a.ctypes.data, b[1:]
    del a
    c = pipe._frame_array()
    assert c.ctypes.data == a_ptr  # a was let go of: reused
    del b
    d = pipe._frame_array()
    assert d.ctypes.data not in (a_ptr, view.base.ctypes.data)
    kept = [pipe._frame_array() for _ in range(5)]
    assert len({k.ctypes.data for k in kept}) == 5
    assert len(pipe._handed) <= 3


def test_a_paced_source_retires_each_frame_alone():
    """Frame j due at t0 + j * period, slower than the stand-in device's
    work: each frame reaches the sink before the next is due, about the
    device's time after its own due time, retired with no next frame
    waiting."""
    period, d_dev, n = 0.050, 0.008, 8
    pipe, _ = _stand_in_pipe(d_dev)
    due, arrivals = [], []

    def source():
        t0 = time.perf_counter() + 0.01
        for j in range(n):
            due.append(t0 + j * period)
            wait = due[j] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            yield np.zeros((16, 16, 3), np.uint8)

    before = dict(COUNTERS)
    stats = pipe.run(source(), sink=lambda out: arrivals.append(
        time.perf_counter()))
    assert stats["frames"] == len(arrivals) == n
    assert _retired(before) == (n, 0)
    latency = [a - d for a, d in zip(arrivals, due)]
    assert max(latency) < period, latency
    assert d_dev <= np.median(latency) < d_dev + 0.25 * period, latency


def test_a_closed_loop_retires_each_frame_behind_the_next():
    """A source that never waits: each frame but the last is fetched after
    the next frame's dispatch (the last has no next frame)."""
    n = 12
    pipe, device = _stand_in_pipe(0.006)
    before = dict(COUNTERS)
    stats = pipe.run(iter([np.zeros((16, 16, 3), np.uint8)] * n))
    assert stats["frames"] == len(device.spans) == n
    assert _retired(before) == (1, n - 1)


def test_errors_on_the_producer_thread_reach_the_caller():
    pipe, _ = _stand_in_pipe(0.001)

    def source():
        yield np.zeros((16, 16, 3), np.uint8)
        yield np.zeros((16, 16, 3), np.uint8)
        raise ValueError("the capture was lost")

    with pytest.raises(ValueError, match="the capture was lost"):
        pipe.run(source())

    def preprocess(frame):
        raise RuntimeError("no resize")

    with pytest.raises(RuntimeError, match="no resize"):
        pipe.run(iter(_frames(3, (16, 16))), preprocess=preprocess)


def _counting_source(pulls):
    while True:
        pulls.append(time.perf_counter())
        yield np.zeros((16, 16, 3), np.uint8)


def test_an_interrupted_run_pulls_no_further_frame():
    pipe, _ = _stand_in_pipe(0.002)
    pulls, shown = [], []

    def sink(out):
        shown.append(out)
        if len(shown) == 3:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        pipe.run(_counting_source(pulls), sink=sink)
    pulled = len(pulls)
    # The frame in flight and the one pulled ahead, at most.
    assert len(shown) == 3 and pulled <= len(shown) + 2
    time.sleep(0.05)
    assert len(pulls) == pulled
    assert not any(t.name == "StreamPipeline.producer"
                   for t in threading.enumerate())


def test_max_frames_bounds_the_pulls():
    pipe, _ = _stand_in_pipe(0.001)
    pulls = []
    stats = pipe.run(_counting_source(pulls), max_frames=3)
    assert stats["frames"] == len(pulls) == 3
