"""The PNG writer (``png.write_png``), PIL's BICUBIC resize in the host
library (``native.resize_bicubic_u8``) and the stream CLI's ``--source`` /
``--save_last`` on PNGs without PIL."""

import builtins
import io

import numpy as np
import pytest
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import native
from transformerupscaler_torch import stream as stream_cli
from transformerupscaler_torch.png import decode_png, encode_png, read_png, \
    write_png


@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 9, 3), (37, 53, 3),
                                   (256, 300, 3)])
def test_write_png_round_trips_through_read_png_and_pil(tmp_path, shape):
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, shape, np.uint8)
    img[: shape[0] // 2] = img[: shape[0] // 2] // 32 * 32  # flat runs too
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
    with Image.open(tmp_path / "a.png") as pil:
        assert pil.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(pil), img)


def test_read_png_reads_pil_filters_after_the_fast_path():
    """PIL picks a filter per row (Paeth, Average, Up...): read_png's
    None/Sub fast path must not catch those files."""
    yy, xx = np.mgrid[0:64, 0:96]
    img = np.stack([yy * 3, xx * 2, (yy + xx) % 256], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)
    assert decode_png(encode_png(img)).tobytes() == img.tobytes()


def test_write_png_rejects_what_it_cannot_write(tmp_path):
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3),
                                                          np.uint8)):
        with pytest.raises(ValueError):
            write_png(tmp_path / "x.png", bad)


@pytest.mark.parametrize("src_hw,out_hw", [
    ((48, 64), (96, 128)), ((37, 53), (111, 159)), ((24, 32), (144, 192)),
    ((96, 128), (48, 64)), ((101, 77), (30, 41)), ((40, 60), (40, 17)),
    ((33, 20), (70, 20)), ((90, 160), (270, 480)),
], ids=["x2", "x3", "x6", "half", "down_odd", "width_only", "height_only",
        "x3_90x160"])
def test_bicubic_matches_pil(src_hw, out_hw):
    """PIL's BICUBIC, bit for bit: the same 22-bit fixed-point weights and
    the same two uint8 passes."""
    rng = np.random.default_rng(sum(src_hw))
    img = rng.integers(0, 256, (*src_hw, 3), np.uint8)
    before = native.CALLS["resize_bicubic_u8"]
    got = native.resize_bicubic_u8(img, out_hw)
    want = np.asarray(Image.fromarray(img).resize(out_hw[::-1],
                                                  Image.BICUBIC))
    assert native.CALLS["resize_bicubic_u8"] == before + 1
    np.testing.assert_array_equal(got, want)


def test_bicubic_rejects_bad_shapes():
    with pytest.raises(RuntimeError, match="returned 1"):
        native.resize_bicubic_u8(np.zeros((8, 8, 17), np.uint8), (4, 4))
    with pytest.raises(ValueError, match="HWC"):
        native.resize_bicubic_u8(np.zeros((8, 8), np.uint8), (4, 4))


def test_stream_cli_source_and_save_last_without_pil(tmp_path, monkeypatch,
                                                     capsys):
    """--source reads a directory of PNGs and --save_last writes one, with
    PIL's import blocked: the last frame written is the BicubicInterpolation
    pipeline's output of the last source frame; .jpg targets raise naming
    the encoder."""
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (16, 32, 3), np.uint8) for _ in range(2)]
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames):
        write_png(src / f"{i}.png", f)
    monkeypatch.setitem(stream_cli.resolutions, "t16", (16, 32))
    monkeypatch.setitem(stream_cli.resolutions, "t32", (32, 64))
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    argv = ["--model", "BicubicInterpolation", "--res_in", "t16",
            "--res_out", "t32", "--frames", "3", "--device", "cpu",
            "--source", str(src)]
    args = stream_cli.parser().parse_args(
        argv + ["--save_last", str(tmp_path / "last.png")])
    stats = stream_cli.main(args)
    assert "last frame saved" in capsys.readouterr().out
    assert stats["frames"] == 3
    pipe = stream_cli.build_pipeline(args)
    want = pipe.step(frames[0])  # the frames cycle: 0, 1, 0
    np.testing.assert_array_equal(read_png(tmp_path / "last.png"), want)
    with pytest.raises(ValueError, match="no JPEG encoder"):
        stream_cli.main(stream_cli.parser().parse_args(
            argv + ["--save_last", str(tmp_path / "last.jpg")]))
