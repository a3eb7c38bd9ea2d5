"""The port's capture helpers and frontends (transformerupscaler_torch/
capture.py, stream.py, app_overlay.py, overlay.py) with fake backends and
displays, as tests/test_overlay.py drives the JAX ones: window selection,
the mss region helper, the platform mapping, the pipeline built with the
trained checkpoint or flagged seeded weights, the BGR flip in the device
step, the whole overlay loop (frames flow, resized into the window's
bounds, tracking every 50 frames), the ``--fast`` / ``--quality`` flag
choice per device, and the stream CLI end to end on the CPU."""

import argparse

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import app_overlay, capture
from transformerupscaler_torch import stream as stream_cli
from transformerupscaler_torch.capture import (
    CaptureBackend,
    LinuxMssBackend,
    WindowInfo,
    select_window,
)
from transformerupscaler_torch.png import write_png
from transformerupscaler_torch.stream_lib import StreamPipeline


class FakeBackend(CaptureBackend):
    name = "fake"

    def __init__(self, n_windows=3, size=(40, 64)):
        self.size = size
        self.windows = [WindowInfo(f"win{i}", left=10 * i, top=5 * i,
                                   width=size[1], height=size[0], handle=i)
                        for i in range(n_windows)]
        self.moved = False
        self.click_through_calls = []

    def list_windows(self):
        return self.windows

    def capture(self, window):
        h, w = self.size
        return np.full((h, w, 3), window.handle * 10 + 7, np.uint8)

    def refresh_bounds(self, window):
        self.moved = True
        return WindowInfo(window.title, window.left + 1, window.top + 1,
                          window.width, window.height, window.handle)

    def make_click_through(self, overlay_title):
        self.click_through_calls.append(overlay_title)
        return True


def test_select_window_uses_chooser_and_checks_range():
    backend = FakeBackend()
    assert select_window(backend, chooser=lambda n: 2).title == "win1"
    with pytest.raises(ValueError):
        select_window(backend, chooser=lambda n: 99)
    with pytest.raises(RuntimeError):
        select_window(FakeBackend(n_windows=0), chooser=lambda n: 1)


def test_mss_region_helper_and_platform_mapping(monkeypatch):
    region = LinuxMssBackend.region(5, 6, 100, 50)
    assert region.bounds == (5, 6, 100, 50)
    assert region.handle == {"left": 5, "top": 6, "width": 100, "height": 50}
    made = []
    for cls in ("MacQuartzBackend", "WindowsBackend", "LinuxMssBackend"):
        monkeypatch.setattr(capture, cls,
                            type(cls, (), {"__init__": lambda s, c=cls:
                                           made.append(c)}))
    for system in ("Darwin", "Windows", "Linux"):
        capture.pick_backend(system)
    assert made == ["MacQuartzBackend", "WindowsBackend", "LinuxMssBackend"]


def test_pipeline_loads_the_trained_checkpoint(tmp_path):
    pipe = StreamPipeline("FastTransformer", (16, 16), (32, 32),
                          dtype=torch.float32, device="cpu")
    assert pipe.from_checkpoint
    from transformerupscaler_torch.checkpoint import load_latest_params

    want = load_latest_params("FastTransformer")["params"]["conv1"]["kernel"]
    np.testing.assert_array_equal(pipe.model.conv1.kernel.numpy(), want)
    seeded = StreamPipeline("FastTransformer", (16, 16), (32, 32),
                            device="cpu",
                            checkpoint_dir=str(tmp_path / "missing"))
    assert not seeded.from_checkpoint


def test_bgr_out_swaps_channels_in_the_step():
    kw = dict(dtype=torch.float32, device="cpu")
    rgb = StreamPipeline("BicubicInterpolation", (8, 8), (16, 16), **kw)
    bgr = StreamPipeline("BicubicInterpolation", (8, 8), (16, 16),
                         bgr_out=True, **kw)
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[..., 0] = 200
    a, b = rgb.step(frame), bgr.step(frame)
    np.testing.assert_array_equal(a[..., 0], b[..., 2])
    np.testing.assert_array_equal(a[..., 2], b[..., 0])


def _overlay_args(**kw):
    base = dict(model="BicubicInterpolation", checkpoint_dir=None,
                res_out="1080", res_in=None, region=None, compile=False,
                quantize=False)
    return argparse.Namespace(**{**base, **kw})


def test_run_overlay_loop_with_fakes():
    backend = FakeBackend(size=(16, 16))
    pipe = StreamPipeline("BicubicInterpolation", (16, 16), (32, 32),
                          dtype=torch.float32, bgr_out=True, device="cpu")
    shown = []
    app_overlay.run_overlay(
        _overlay_args(), backend=backend, pipe=pipe, chooser=lambda n: 1,
        imshow=lambda f: shown.append(f.copy()) or True, max_frames=55)
    assert len(shown) == 55
    assert shown[0].shape == (16, 16, 3)  # resized into the window bounds
    assert backend.moved  # refresh_bounds at iteration 50
    assert pipe.timer.iterations == 55


@pytest.mark.parametrize("device,pallas,attn", [
    (None, True, "fused2"), ("cpu", False, "xla")])
@pytest.mark.parametrize("mode", ["fast", "quality"])
def test_fast_flags_per_device(monkeypatch, device, pallas, attn, mode):
    """--fast / --quality: the stream kernels and the fused trunk on the
    card, JAX's off-TPU choice (the all-XLA packed path, attention "xla")
    with --device cpu; in app_overlay and in the stream CLI."""
    built = {}

    class Spy(StreamPipeline):
        def __init__(self, *a, **kw):
            built.update(kw)
            super().__init__("BicubicInterpolation", (16, 32), (32, 64),
                             bgr_out=True, load_checkpoint=False,
                             device="cpu")

    monkeypatch.setattr(app_overlay, "StreamPipeline", Spy)
    args = _overlay_args(model="FastTransformer", res_out="720",
                         res_in="360", fast=mode == "fast",
                         quality=mode == "quality", device=device)
    shown = []
    app_overlay.run_overlay(args, backend=FakeBackend(size=(16, 32)),
                            chooser=lambda n: 1,
                            imshow=lambda f: shown.append(True) or True,
                            max_frames=3)
    assert len(shown) == 3
    assert built["pallas_serve"] is pallas and built["attn_impl"] == attn
    assert built["compose_tails"] and built["packed_serve"]
    assert built["serve_quality"] is (mode == "quality")
    assert built["device"] == device and built["bgr_out"]

    cli = stream_cli.parser().parse_args(
        [f"--{mode}"] + ([] if device is None else ["--device", device]))
    flags = stream_cli.pipeline_flags(cli)
    assert flags["pallas_serve"] is pallas and flags["attn_impl"] == attn
    assert flags["compose_tails"] and flags["packed_serve"]
    assert flags["serve_quality"] is (mode == "quality")


def test_stream_cli_flags_follow_jax():
    """Without --fast: the exact path; --int8 tails keeps the stream kernels
    even on the CPU (JAX stream.py:49-59)."""
    parse = stream_cli.parser().parse_args
    plain = stream_cli.pipeline_flags(parse(["--device", "cpu"]))
    assert plain == dict(quantize=False, int8_mlp=False, int8_serve=False,
                         int8_scope="full", compose_tails=False,
                         packed_serve=False, pallas_serve=False,
                         serve_quality=False, attn_impl="xla")
    tails = stream_cli.pipeline_flags(
        parse(["--int8", "tails", "--int8_mlp", "--device", "cpu"]))
    assert tails["pallas_serve"] and tails["int8_serve"]
    assert tails["int8_scope"] == "tails" and tails["int8_mlp"]
    assert tails["compose_tails"] and tails["attn_impl"] == "xla"


def test_stream_cli_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setitem(stream_cli.resolutions, "t16", (16, 32))
    monkeypatch.setitem(stream_cli.resolutions, "t32", (32, 64))
    args = stream_cli.parser().parse_args(
        ["--model", "BicubicInterpolation", "--res_in", "t16", "--res_out",
         "t32", "--frames", "4", "--device", "cpu"])
    stats = stream_cli.main(args)
    out = capsys.readouterr().out
    assert stats["frames"] == 4 and "fps" in out and "Profiling" in out


def test_frontends_need_their_display_packages(monkeypatch, tmp_path):
    """overlay needs cv2 and mss, app_overlay cv2: without them each exits
    saying so, never a silent fallback. The stream CLI's --source needs no
    PIL: it reads PNGs with ``png.read_png``, and a .jpg raises naming the
    missing decoder."""
    import builtins

    from transformerupscaler_torch import overlay

    real_import = builtins.__import__

    def no_display(name, *a, **kw):
        if name in ("cv2", "mss", "PIL"):
            raise ImportError(f"no {name}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_display)
    with pytest.raises(SystemExit, match="transformerupscaler_torch.stream"):
        overlay.main(argparse.Namespace(model="BicubicInterpolation",
                                        checkpoint_dir=None, device="cpu"))
    with pytest.raises(SystemExit, match="OpenCV"):
        app_overlay.main(_overlay_args())
    args = stream_cli.parser().parse_args(
        ["--model", "BicubicInterpolation", "--device", "cpu", "--source",
         str(tmp_path)])
    frame = np.random.default_rng(0).integers(0, 256, (16, 32, 3), np.uint8)
    write_png(tmp_path / "a.png", frame)
    np.testing.assert_array_equal(
        next(stream_cli.frame_source(args, (16, 32))), frame)
    (tmp_path / "b.jpg").write_bytes(b"")
    with pytest.raises(ValueError, match="JPEG decoder"):
        stream_cli.frame_source(args, (16, 32))
