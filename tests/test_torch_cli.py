"""The port's inference, A/B and speed-test command lines against the root
JAX ones, on the CPU.

Both sides run in process (``main(args)``) in a temporary working
directory, on seeded PNGs, with PNG paths on both sides (the root CLIs
write their outputs through PIL; the port through ``png.write_png``).
BicubicInterpolation carries the plumbing, and one FastTransformer call
(48x64 at x2, the committed epoch-100 weights, the exact f32 path) the
model.

Where the two sides can differ, and the bounds held:

- The port resizes uint8 images with ``native.resize_bilinear_u8``, within
  one level of PIL's (tests/test_torch_native.py); the root CLIs with PIL.
  So the downscaled input and the scores' bilinear resizes may differ by a
  level: the saved input within 1 level (at 48x64 -> 24x32, 85% of its
  pixels equal, measured here), the scores within 2e-3 (SSIM) and 0.05 dB
  (PSNR) (measured here: <= 1e-4 and <= 0.01 dB). The dataset's samples
  differ likewise, and an MSE of ~1e-3 moves by ~1% with them; so the A/B
  CLIs are compared on the same samples (the root CLI given the port's
  dataset class, whose parity tests/test_torch_data.py holds): the totals
  within 1e-5 relative.
- The upscaled output is written as truncated uint8, which turns an f32
  rounding apart at a level's edge into one level. Bicubic at x3 puts
  whole phases of pixels on levels (a tap of weight 1), where f32 sums in
  another order land a rounding below: 0.15% of its pixels flip (measured
  here). So: within 1 level, >= 99.8% equal, and every pixel apart has a
  float output within 1e-3 of a level.
- The bicubic control image (PIL's BICUBIC in the root CLI, which writes
  it as ``bicubic.jpg``) is held bit for bit against PIL's on the port's
  own input.
"""

import argparse
import importlib
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import ab_test as jax_ab
import inference as jax_inference
import speed_test as jax_speed
from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import ab_test, inference, speed_test
from transformerupscaler_torch.png import read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_CKPT = os.path.join(ROOT, "models", "FastTransformer", "checkpoints")
SMALL_RES = {"t24": (24, 32), "t192": (192, 192)}


def _seeded_png(path, hw, seed=0):
    """A smooth seeded image (noise on a gradient), as PNG."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([yy / hw[0], xx / hw[1], (yy + xx) / sum(hw)], -1)
    img = np.clip(base * 200 + rng.normal(0, 20, (*hw, 3)), 0, 255)
    write_png(path, img.astype(np.uint8))


def _shape(line: str) -> str:
    """A report line with its numbers and paths' extensions blanked."""
    return re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def _lines(out: str) -> list:
    return [ln for ln in out.splitlines() if not ln.startswith("Running")]


def _levels(a: np.ndarray, b: np.ndarray) -> tuple:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d == 0).mean())


@pytest.fixture
def small_res(monkeypatch):
    """Small named resolutions in both packages' tables."""
    for pkg in ("transformerupscaler_tpu", "transformerupscaler_torch"):
        table = importlib.import_module(f"{pkg}.resolutions").resolutions
        for k, v in SMALL_RES.items():
            monkeypatch.setitem(table, k, v)


def _run_both_inference(tmp_path, monkeypatch, capsys, extra):
    """The root CLI, then the port's, on the same flags; their stdout and
    the port's result."""
    monkeypatch.chdir(tmp_path)
    args = inference.parser().parse_args(
        ["--image_path", str(tmp_path / "image.png"), "--inp",
         "port_input.png", "--out", "port_model.png", "--device", "cpu",
         *extra])
    jax_args = argparse.Namespace(**{**vars(args), "inp": "jax_input.png",
                                     "out": "jax_model.png"})
    del jax_args.device
    jax_inference.main(jax_args)
    jax_out = capsys.readouterr().out
    got = inference.main(args)
    return jax_out, capsys.readouterr().out, got


def _scores(out: str) -> dict:
    vals = {}
    for arm in ("Bicubic", "Model"):
        m = re.search(arm + r" Scores:\tSSIM: ([\d.]+), PSNR: ([\d.]+|inf) dB",
                      out)
        vals[arm] = (float(m.group(1)), float(m.group(2)))
    return vals


@pytest.mark.parametrize("extra,scale", [
    (["--model", "BicubicInterpolation", "--scale", "3"], 3),
    (["--model", "BicubicInterpolation", "--scale", "2", "--res_in", "t24"],
     2),
    (["--model", "FastTransformer", "--scale", "2", "--checkpoint_dir",
      FAST_CKPT], 2),
], ids=["bicubic_x3", "bicubic_res_in_x2", "fast_exact_x2"])
def test_inference_cli_matches_jax(tmp_path, monkeypatch, capsys, small_res,
                                   extra, scale):
    hw = (48, 64)
    _seeded_png(tmp_path / "image.png", hw)
    jax_out, port_out, got = _run_both_inference(tmp_path, monkeypatch,
                                                 capsys, extra)
    # The same report, line by line (the bicubic image is a .png here).
    assert [_shape(ln) for ln in _lines(jax_out)] == [
        _shape(ln.replace("bicubic.png", "bicubic.jpg").replace(
            "port_", "jax_")) for ln in _lines(port_out)], port_out
    # The downscaled input (PIL's bilinear vs the native filter).
    lvl, _ = _levels(read_png(tmp_path / "port_input.png"),
                     np.asarray(Image.open(tmp_path / "jax_input.png")))
    assert lvl <= 1
    # The bicubic control image: PIL's BICUBIC, bit for bit.
    lr = read_png(tmp_path / "port_input.png")
    want = Image.fromarray(lr).resize((lr.shape[1] * scale,
                                       lr.shape[0] * scale), Image.BICUBIC)
    np.testing.assert_array_equal(read_png(tmp_path / "bicubic.png"),
                                  np.asarray(want))
    # The output pixels: a pixel apart only where the float output sits
    # within f32 rounding of a level (truncation flips it).
    port_px = read_png(tmp_path / "port_model.png")
    jax_px = np.asarray(Image.open(tmp_path / "jax_model.png"))
    lvl, eq = _levels(port_px, jax_px)
    if "--res_in" in extra:
        # Inputs a level apart (above), through bicubic's taps (their
        # absolute sum in 2-d is 1.44 at most) and the truncation.
        assert lvl <= 2, lvl
    else:
        assert lvl <= 1 and eq >= 0.998, (lvl, eq)
        v = np.clip(got["output"], 0, 1)[port_px != jax_px] * 255
        assert np.abs(v - np.round(v)).max(initial=0) <= 1e-3
    want, have = _scores(jax_out), _scores(port_out)
    for arm in ("Bicubic", "Model"):
        assert abs(want[arm][0] - have[arm][0]) <= 2e-3, (arm, want, have)
        assert want[arm][1] == have[arm][1] or \
            abs(want[arm][1] - have[arm][1]) <= 0.05, (arm, want, have)
    lr_hw = SMALL_RES["t24"] if "--res_in" in extra else hw
    assert got["output"].shape == (lr_hw[0] * scale, lr_hw[1] * scale, 3)


def test_inference_cli_rejects_jpeg_and_defaults_to_png(tmp_path):
    parse = inference.parser().parse_args
    defaults = parse([])
    assert (defaults.inp, defaults.out) == ("input.png", "model.png")
    _seeded_png(tmp_path / "image.png", (16, 16))
    for bad, codec in ((["--image_path", str(tmp_path / "a.jpg")],
                        "decoder"),
                       (["--out", "model.jpg"], "encoder"),
                       (["--inp", "input.jpg"], "encoder")):
        args = parse(["--image_path", str(tmp_path / "image.png"),
                      "--device", "cpu", *bad])
        with pytest.raises(ValueError, match=f"no JPEG {codec}"):
            inference.main(args)


def _dataset_dir(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    _seeded_png(d / "a.png", (60, 100), seed=1)
    return d


def test_ab_test_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """Bicubic against itself over one image's ten scale pairs, with the
    heights restricted (``_resize_to_height``'s float path on both
    sides)."""
    data = _dataset_dir(tmp_path)
    argv = ["--data_dir", str(data), "--model_a", "BicubicInterpolation",
            "--model_b", "BicubicInterpolation", "--res_in", "96",
            "--res_out", "288", "--log_interval", "3"]
    monkeypatch.setattr(jax_ab, "HighresImageDataset",
                        ab_test.HighresImageDataset)
    jax_ab.main(ab_test.parser().parse_args(argv))
    jax_out = capsys.readouterr().out
    got = ab_test.main(ab_test.parser().parse_args(argv + ["--device",
                                                           "cpu"]))
    port_out = capsys.readouterr().out
    assert [_shape(ln) for ln in _lines(jax_out)] == [
        _shape(ln) for ln in _lines(port_out)]
    totals = [float(v) for v in re.findall(r"Total Loss: ([\d.]+)", jax_out)]
    assert got["processed"] == 10 and len(totals) == 2
    for want, have in zip(totals, (got["total_loss_a"],
                                   got["total_loss_b"])):
        # The root CLI prints six decimals.
        assert abs(have - want) <= 1e-5 * want + 5e-7, (want, have)


def test_resize_to_height_matches_jax():
    """torchvision's truncating size rule and the float antialiased
    bilinear resize, against the root CLI's helper."""
    rng = np.random.default_rng(2)
    for hw, height in (((60, 100), 96), ((100, 60), 40), ((37, 53), 17)):
        img = rng.random((*hw, 3), np.float32)
        want = jax_ab._resize_to_height(img, height)
        got = ab_test.resize_to_height(img, height)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_speed_test_cli_matches_jax(tmp_path, capsys, small_res):
    """Bicubic to 192x192: every one of the ten samples served, the same
    report lines; ``--mesh 2`` (a mesh of the CPU repeated on the port's
    side, of two of the eight virtual CPU devices on JAX's): the four 96x96
    samples at x2 in one geometry, the rest skipped, as in the root CLI."""
    data = _dataset_dir(tmp_path)
    argv = ["--data_dir", str(data), "--model", "BicubicInterpolation",
            "--res_out", "t192"]
    for mesh, served in (([], 10), (["--mesh", "2"], 4)):
        jax_speed.main(speed_test.parser().parse_args(argv + mesh))
        jax_out = capsys.readouterr().out
        got = speed_test.main(speed_test.parser().parse_args(
            argv + mesh + ["--device", "cpu"]))
        port_out = capsys.readouterr().out
        assert [_shape(ln) for ln in _lines(jax_out)] == [
            _shape(ln) for ln in _lines(port_out)], (jax_out, port_out)
        assert got["images"] == served and got["skipped"] == 10 - served


def test_speed_test_skips_what_the_model_refuses(tmp_path, capsys,
                                                 small_res, monkeypatch):
    """A geometry whose forward raises ValueError (as FastTransformer's
    upsampler does for a scale outside {2, 3, 4, 6}) is skipped and
    counted, once reported, and kept out of the averages."""
    class Refusing(speed_test.UpscalerEngine):
        def upscale(self, image, *a, **kw):
            if np.asarray(image).shape[-3:-1] == (96, 96):
                raise ValueError("unsupported scale")
            return super().upscale(image, *a, **kw)

    monkeypatch.setattr(speed_test, "UpscalerEngine", Refusing)
    got = speed_test.main(speed_test.parser().parse_args(
        ["--data_dir", str(_dataset_dir(tmp_path)), "--model",
         "BicubicInterpolation", "--res_out", "t192", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert got["skipped"] == 4 and got["images"] == 6
    assert out.count("Skipping unsupported sample geometry (96, 96)") == 1
    assert "Skipped 4 samples with unsupported scales" in out


def test_profiling_sampler_and_trace(tmp_path):
    """``profiling.trace`` (``train --traceback``) writes a Chrome trace of
    the block."""
    import json

    from transformerupscaler_torch import profiling

    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
