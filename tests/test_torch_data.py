"""The port's training data against the JAX package's
(transformerupscaler_tpu/data/): the geometry bucketing and the shuffled
batches; the PNG reader (transformerupscaler_torch/png.py) against PIL bit
for bit; the datasets; and the checkpoints the port's trainer writes, read
back and served by the engine.

The port resizes with its native library (PIL's antialiased bilinear in
C++), the JAX package with PIL: uint8 pixels within one level of each
other, the bound tests/test_native.py holds the JAX package's own copy to.
On the images here about a fifth of the values differ by that one level
(0.195 of 1,086,096 when this test was written); none by more.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import checkpoint as C
from transformerupscaler_torch import png
from transformerupscaler_torch.data import bucketing as B
from transformerupscaler_torch.data.datasets import (
    HighresImageDataset,
    OnlineHighresDataset,
)
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.resolutions import SCALE_PAIRS
from transformerupscaler_torch.weights import (
    flatten,
    params_from_jax,
    params_to_jax,
    seeded_params,
    unflatten,
)
from transformerupscaler_tpu.data import bucketing as JB
from transformerupscaler_tpu.data.datasets import (
    HighresImageDataset as JaxHighresImageDataset,
)
from transformerupscaler_tpu.resolutions import SCALE_PAIRS as JAX_PAIRS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_PNGS = sorted(
    os.path.join(ROOT, "models", m, "demo", f)
    for m in ("FastTransformer", "WindowTransformer", "ResidualTransformer")
    for f in os.listdir(os.path.join(ROOT, "models", m, "demo"))
    if f.endswith(".png"))
SMALL = dict(transformer_dim=32, num_window_blocks=1, num_heads=2)
PAIRS = [{"lr": (24, 40), "hr": (48, 80)}, {"lr": (50, 70), "hr": (150, 210)},
         {"lr": (96, 96), "hr": (300, 440)}]


def _image(seed: int, hw=(150, 220)) -> np.ndarray:
    """A smooth pattern with noise: resizes of it round near .5 often
    enough to show where two resizers differ."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    wave = np.sin(x / 7.0 + seed)[..., None] * np.cos(y / 11.0)[..., None]
    return (127 + 100 * wave + rng.normal(0, 20, (*hw, 3))).clip(
        0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    for i in range(2):
        Image.fromarray(_image(i)).save(d / f"im{i}.png")
    return d


# ---------------------------------------------------------------- bucketing
def _samples(seed):
    rng = np.random.default_rng(seed)
    geoms = [((16, 16), (32, 32)), ((8, 12), (16, 24)), ((16, 16), (24, 24))]
    return [tuple(rng.random((*g, 3)).astype(np.float32) for g in
                  geoms[int(rng.integers(0, 3))]) for _ in range(7)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bucketing_and_batches_equal_jax(seed):
    samples = _samples(seed)
    got, want = B.bucket_batch(samples), JB.bucket_batch(samples)
    assert list(got) == list(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    data = list(range(11))
    for bs in (1, 3, 4):
        for drop_last in (False, True):
            assert list(B.batched(data, bs, True, seed, drop_last)) == \
                list(JB.batched(data, bs, True, seed, drop_last))
    assert list(B.prefetched(iter(data))) == data


def test_bucketing_stacks_tensors_with_torch():
    lr, hr = torch.zeros(4, 4, 3), torch.ones(8, 8, 3)
    (lrs, hrs), = B.bucket_batch([(lr, hr), (lr, hr)]).values()
    assert isinstance(lrs, torch.Tensor) and lrs.shape == (2, 4, 4, 3)
    assert isinstance(hrs, torch.Tensor) and hrs.shape == (2, 8, 8, 3)


def test_prefetched_raises_the_iterators_error():
    def items():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(B.prefetched(items()))


def test_scale_pairs_equal_jax():
    assert list(SCALE_PAIRS) == list(JAX_PAIRS)


# ---------------------------------------------------------------------- PNG
@pytest.mark.parametrize("path", DEMO_PNGS,
                         ids=lambda p: "/".join(p.split(os.sep)[-3::2]))
def test_png_reads_the_demo_images_as_pil(path):
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(png.read_png(path), want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _refilter(data: bytes, ftype: int) -> bytes:
    """The PNG ``data`` with every row filtered with ``ftype`` (0-4), the
    other chunks as they were."""
    chunks, pos = [], 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[0][1][:10])
    bpp = png.CHANNELS[ctype]
    idat = b"".join(p for k, p in chunks if k == b"IDAT")
    px = png._unfilter(np.frombuffer(zlib.decompress(idat), np.uint8)
                       .reshape(h, 1 + w * bpp), h, w, bpp)
    x = px.reshape(h, w * bpp).astype(np.int16)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pred = [np.zeros_like(x), left, up, (left + up) >> 1,
            _paeth(left, up, ul)][ftype]
    rows = ((x - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), rows], 1)
    out = [data[:8]]
    body = [(k, p) for k, p in chunks if k != b"IDAT"]
    body.insert(len(body) - 1, (b"IDAT", zlib.compress(raw.tobytes())))
    for kind, payload in body:
        out.append(struct.pack(">I", len(payload)) + kind + payload +
                   struct.pack(">I", zlib.crc32(kind + payload)))
    return b"".join(out)


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reads_each_mode_and_filter_as_pil(tmp_path, mode, ftype):
    rgb = _image(3, (37, 53))
    if mode == "P":
        img = Image.fromarray(rgb).quantize(colors=50)
    else:
        img = Image.fromarray(rgb).convert(mode)
        if "A" in mode:
            alpha = np.random.default_rng(4).integers(0, 256, (37, 53))
            img.putalpha(Image.fromarray(alpha.astype(np.uint8)))
    path = tmp_path / "x.png"
    img.save(path)
    path.write_bytes(_refilter(path.read_bytes(), ftype))
    want = np.asarray(Image.open(path).convert("RGB"))
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


def test_png_raises_on_what_it_does_not_read(tmp_path):
    path = tmp_path / "x.png"
    Image.fromarray(_image(5, (8, 8))).save(path)
    good = path.read_bytes()
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF  # inside the first IDAT's payload
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)).save(
        tmp_path / "deep.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(tmp_path / "deep.png")
    # An interlaced header, as Adam7 files carry it.
    hdr = bytearray(good[16:29])
    hdr[12] = 1
    il = (good[:8] + struct.pack(">I", 13) + b"IHDR" + bytes(hdr) +
          struct.pack(">I", zlib.crc32(b"IHDR" + bytes(hdr))) + good[33:])
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(il)
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(good[:-20])


# ----------------------------------------------------------------- datasets
@pytest.mark.parametrize("uint8", [False, True])
def test_highres_dataset_against_jax(image_dir, uint8):
    """Same length and pair order as the JAX dataset; pixels within one
    level (module docstring); float32 samples are the uint8 ones / 255."""
    got = HighresImageDataset(str(image_dir), scale_pairs=PAIRS, uint8=uint8)
    want = JaxHighresImageDataset(str(image_dir), scale_pairs=PAIRS,
                                  uint8=uint8)
    assert len(got) == len(want) == 6
    assert got.image_files == want.image_files
    differ = total = 0
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            assert g.shape == w.shape and g.dtype == w.dtype
            step = np.abs(g.astype(np.float64) - w) * (1 if uint8 else 255)
            assert step.max() <= 1.0 + 1e-4
            differ += int((step > 0.5).sum())
            total += step.size
    assert differ / total <= 0.25, (differ, total)
    if not uint8:
        u8 = HighresImageDataset(str(image_dir), scale_pairs=PAIRS,
                                 uint8=True)
        for i in range(len(u8)):
            for f, q in zip(got[i], u8[i]):
                np.testing.assert_array_equal(
                    f, q.astype(np.float32) / np.float32(255.0))


def test_highres_dataset_length_cap_and_cache(image_dir):
    ds = HighresImageDataset(str(image_dir))
    assert len(ds) == 20  # two images x ten pairs, under the 200 cap
    assert len(HighresImageDataset(str(image_dir), length=7)) == 7
    cached = HighresImageDataset(str(image_dir), scale_pairs=PAIRS,
                                 cache=True)
    assert cached[1] is cached[1]


def test_online_dataset_with_fetch_fn_and_fallback_dir(image_dir, tmp_path):
    imgs = [_image(7, (60, 80)), _image(8, (60, 80))]
    calls = {"n": 0}

    def fetch():
        calls["n"] += 1
        return imgs[calls["n"] % 2]

    pairs = [{"lr": (12, 16), "hr": (24, 32)},
             {"lr": (20, 20), "hr": (40, 40)}]
    ds = OnlineHighresDataset(fetch_fn=fetch, batch_download_count=2,
                              minimum_cache=1, length=5)
    ds.scale_pairs, ds.num_scale_pairs = pairs, 2
    try:
        assert len(ds) == 5
        items = [ds[i] for i in range(4)]
        assert [tuple(a.shape[:2]) for a, _ in items] == [
            (12, 16), (20, 20), (12, 16), (20, 20)]
        assert all(a.dtype == np.float32 and 0 <= a.min() and a.max() <= 1
                   for pair in items for a in pair)
    finally:
        ds.close()
    assert not ds.thread.is_alive()
    fb = OnlineHighresDataset(fallback_dir=str(image_dir),
                              batch_download_count=2, minimum_cache=1)
    try:
        lr, hr = fb[0]
        assert lr.shape == (720, 1280, 3) and hr.shape == (1080, 1920, 3)
    finally:
        fb.close()


def test_online_dataset_raises_without_a_source(tmp_path):
    with pytest.raises(ValueError, match="no network fetch"):
        OnlineHighresDataset()
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(NotImplementedError, match="JPEG"):
        OnlineHighresDataset(fallback_dir=str(tmp_path))
    (tmp_path / "a.jpg").unlink()
    with pytest.raises(ValueError, match="no .png"):
        OnlineHighresDataset(fallback_dir=str(tmp_path))


# -------------------------------------------------------------- checkpoints
def test_save_load_serve_round_trip(tmp_path):
    """save_checkpoint -> get_latest_checkpoint -> load_checkpoint (the
    parameters and the Adam state) -> UpscalerEngine(checkpoint_dir=...),
    which serves what a fresh model with those parameters serves."""
    model = get_model("FastTransformer", device="cpu", **SMALL)
    tree = seeded_params(model, 3)
    rng = np.random.default_rng(0)
    opt = {"mu": unflatten({k: rng.standard_normal(v.shape).astype(np.float32)
                            for k, v in flatten(tree).items()}),
           "nu": tree, "count": 7}
    ck = tmp_path / "ck"
    path = C.save_checkpoint(str(ck), 3, tree, opt)
    C.save_checkpoint(str(ck), 2, tree)
    assert path == str(ck / "model_epoch_3.npz")
    assert sorted(os.listdir(ck)) == ["model_epoch_2.npz",
                                      "model_epoch_3.npz"]
    assert C.get_latest_checkpoint(str(ck)) == (path, 3)
    got = C.load_checkpoint(path)
    flat = flatten
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(flat(got["params"])[k], v)
        np.testing.assert_array_equal(flat(got["opt_state"]["mu"])[k],
                                      flat(opt["mu"])[k])
        np.testing.assert_array_equal(flat(got["opt_state"]["nu"])[k], v)
    assert got["opt_state"]["count"] == 7
    assert C.load_checkpoint(str(ck / "model_epoch_2.npz"))["opt_state"] \
        is None
    # The committed copies load with no Adam state.
    copy = C.COPIES / "WindowTransformer" / "model_epoch_40.npz"
    assert C.load_checkpoint(str(copy))["opt_state"] is None
    engine = UpscalerEngine("FastTransformer", checkpoint_dir=str(ck),
                            device="cpu", **SMALL)
    assert (engine.epoch, engine.checkpoint_path) == (3, path)
    fresh = get_model("FastTransformer", device="cpu", **SMALL)
    params_from_jax(fresh, tree)
    x = np.random.default_rng(1).random((24, 32, 3)).astype(np.float32)
    want = fresh(torch.from_numpy(x)[None], upscale_factor=2)[0].numpy()
    np.testing.assert_array_equal(engine.upscale(x, upscale_factor=2), want)
    flat_model = flat(params_to_jax(engine.model))
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(flat_model[k], v)
