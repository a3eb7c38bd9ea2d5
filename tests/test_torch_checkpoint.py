"""The port's checkpoints against the JAX package's: the numpy copies of the
three default Orbax checkpoints, the trained fixtures the card holds the
port to, ``get_latest_checkpoint`` and the legacy ``.pth`` form.

The card's host reads neither Orbax nor zstd, so each default checkpoint
has a committed numpy copy (transformerupscaler_torch/checkpoints/), and
each model a trained fixture (tests/fixtures/torch_port/trained_<Model>.npz):
its demo input as uint8, the checkpoint's fingerprint and the JAX default
engine's f32 output on the trained weights (FastTransformer and
WindowTransformer: the central 64x96 crop at x2; ResidualTransformer,
whose ``pos_embed`` fixes the 720x1280 frame: the central 128x128 of its
1080x1920 output, and the whole output's sum and mean). Regenerate both
with ``PYTHONPATH=. python tests/test_torch_checkpoint.py`` from the repo
root after a checkpoint changes.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from transformerupscaler_torch import checkpoint as C
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_tpu.checkpoint import (
    get_latest_checkpoint as jax_get_latest,
)
from transformerupscaler_tpu.checkpoint import load_checkpoint as jax_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULTS = {"FastTransformer": 100, "WindowTransformer": 40,
            "ResidualTransformer": 17}
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
CROP = (58, 112, 64, 96)  # y0, x0, h, w: the central crop, served at x2
RESID_RES_OUT, RESID_WINDOW = (1080, 1920), (476, 896, 128, 128)
SMALL = dict(transformer_dim=32, num_window_blocks=1, num_heads=2)


def orbax_dir(name):
    return os.path.join(ROOT, "models", name, "checkpoints",
                        f"model_epoch_{DEFAULTS[name]}")


def fixture_path(name):
    return os.path.join(FIXTURES, f"trained_{name}.npz")


def demo_input(name) -> np.ndarray:
    img = Image.open(os.path.join(ROOT, "models", name, "demo", "input.png"))
    return np.asarray(img.convert("RGB"), np.uint8)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def jax_trees():
    return {name: flat(jax_load(orbax_dir(name), name)["params"])
            for name in DEFAULTS}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_weight_copy_is_fresh(jax_trees, name):
    """The copy the port reads equals the JAX loader's tree bit for bit and
    carries its source's fingerprint."""
    want = jax_trees[name]
    got = flat(C.load_checkpoint(orbax_dir(name))["params"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v.dtype == got[k].dtype == np.float32, k
        assert np.array_equal(got[k], v), k
    with np.load(C.copy_path(orbax_dir(name))) as f:
        assert str(f[C.FINGERPRINT]) == C.fingerprint(orbax_dir(name))


def _touch(d, *names):
    os.makedirs(d, exist_ok=True)
    for n in names:
        if n.endswith(".pth"):
            open(os.path.join(d, n), "wb").close()
        else:
            os.makedirs(os.path.join(d, n))


@pytest.mark.parametrize("entries", [
    ("model_epoch_3", "model_epoch_12", "model_epoch_7x", "other"),
    ("model_epoch_2.pth", "model_epoch_10.pth", "model_epoch_9.pt"),
    ("model_epoch_4", "model_epoch_30.pth", "model_epoch_11"),
    ()], ids=["orbax", "pth", "mixed", "empty"])
def test_latest_checkpoint_agrees_with_jax(tmp_path, entries):
    d = str(tmp_path / "ckpt")
    _touch(d, *entries)
    if not entries:
        for find in (jax_get_latest, C.get_latest_checkpoint):
            with pytest.raises(FileNotFoundError):
                find(d)
        return
    assert C.get_latest_checkpoint(d) == jax_get_latest(d)


GOLDENS = [("window_resout", "WindowTransformer"),
           ("residual_default", "ResidualTransformer"),
           ("fast_upscale3", "FastTransformer")]


@pytest.mark.parametrize("case,name", GOLDENS)
def test_pth_loads_as_jax(tmp_path, case, name):
    """A legacy .pth of the reference's state_dict (the golden fixtures'
    ``sd:`` keys) loads to JAX's tree, bit for bit."""
    with np.load(os.path.join(ROOT, "tests", "golden", f"{case}.npz")) as f:
        sd = {k[3:]: torch.from_numpy(f[k]) for k in f.files
              if k.startswith("sd:")}
    path = str(tmp_path / "model_epoch_5.pth")
    torch.save(sd, path)
    want = flat(jax_load(path, name)["params"])
    got = flat(C.load_checkpoint(path, name)["params"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    with pytest.raises(ValueError, match="model_name"):
        C.load_checkpoint(path)


def _fake_checkpoint(tmp_path, monkeypatch):
    """A two-leaf Orbax-like directory models/FastTransformer/checkpoints/
    model_epoch_5 (a _METADATA and one data file) and its copy, the copies
    directory moved under tmp_path."""
    monkeypatch.setattr(C, "COPIES", tmp_path / "copies")
    d = tmp_path / "models" / "FastTransformer" / "checkpoints"
    src = d / "model_epoch_5"
    src.mkdir(parents=True)
    leaves = {"conv1/kernel": np.ones((3, 3, 3, 4), np.float32),
              "conv1/bias": np.zeros(4, np.float32)}
    meta = {"tree_metadata": {str(("params", *k.split("/"))): {
        "key_metadata": [{"key": p, "key_type": 2}
                         for p in ("params", *k.split("/"))],
        "value_metadata": {"write_shape": list(v.shape)}}
        for k, v in leaves.items()}}
    (src / "_METADATA").write_text(json.dumps(meta))
    (src / "d").mkdir()
    (src / "d" / "data").write_bytes(b"\x28\xb5\x2f\xfd" + bytes(64))
    copy = C.copy_path(str(src))
    copy.parent.mkdir(parents=True)

    def write(**changed):
        np.savez_compressed(copy, **{**leaves, **changed},
                            **{C.FINGERPRINT: np.array(
                                C.fingerprint(str(src)))})
    return d, src, leaves, write


def test_stale_or_missing_copy_raises(tmp_path, monkeypatch):
    d, src, leaves, write = _fake_checkpoint(tmp_path, monkeypatch)
    with pytest.raises(C.StaleCopyError, match="no numpy copy"):
        C.load_checkpoint(str(src))
    # A checkpoint with no copy is not "no checkpoint": the engine raises
    # and does not serve seeded weights.
    with pytest.raises(C.StaleCopyError, match="test_torch_checkpoint"):
        UpscalerEngine("FastTransformer", checkpoint_dir=str(d),
                       device="cpu", **SMALL)
    write()
    got = flat(C.load_checkpoint(str(src))["params"])
    assert all(np.array_equal(got[k], v) for k, v in leaves.items())
    write(**{"conv1/bias": np.zeros(5, np.float32)})
    with pytest.raises(C.StaleCopyError, match="_METADATA"):
        C.load_checkpoint(str(src))
    write()
    with open(src / "d" / "data", "ab") as f:
        f.write(b"\0")
    with pytest.raises(C.StaleCopyError, match="stale"):
        C.load_checkpoint(str(src))
    assert not issubclass(C.StaleCopyError, FileNotFoundError)


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_trained_fixture_is_fresh(name):
    """The trained fixture was written from the checkpoint as it is and
    from the demo input as PIL reads it."""
    with np.load(fixture_path(name)) as f:
        assert str(f["fingerprint"]) == C.fingerprint(orbax_dir(name))
        assert np.array_equal(f["x"], demo_input(name))


def _jax_fixture(name) -> dict:
    """The JAX default engine on the trained weights, on the fixture's
    input (the function the generator writes)."""
    from transformerupscaler_tpu.infer_lib import UpscalerEngine as JaxEngine

    x = demo_input(name)
    engine = JaxEngine(name, root=ROOT)
    assert engine.epoch == DEFAULTS[name]
    out = dict(x=x, fingerprint=np.array(C.fingerprint(orbax_dir(name))),
               epoch=np.array(engine.epoch))
    if name == "ResidualTransformer":
        y = engine.upscale(x, res_out=RESID_RES_OUT)
        r0, c0, h, w = RESID_WINDOW
        out.update(y=y[r0:r0 + h, c0:c0 + w], window=np.array(RESID_WINDOW),
                   res_out=np.array(RESID_RES_OUT),
                   y_sum=np.array(y.astype(np.float64).sum()),
                   y_mean=np.array(y.astype(np.float64).mean()))
    else:
        y0, x0, h, w = CROP
        out.update(y=engine.upscale(x[y0:y0 + h, x0:x0 + w],
                                    upscale_factor=2),
                   crop=np.array(CROP), scale=np.array(2))
    return out


if __name__ == "__main__":
    for model in DEFAULTS:
        src = orbax_dir(model)
        tree = flat(jax_load(src, model)["params"])
        assert all(v.dtype == np.float32 for v in tree.values())
        dest = C.copy_path(src)
        dest.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(dest, **tree, **{
            C.FINGERPRINT: np.array(C.fingerprint(src))})
        print("wrote", dest, os.path.getsize(dest), "bytes")
        np.savez_compressed(fixture_path(model), **_jax_fixture(model))
        print("wrote", fixture_path(model),
              os.path.getsize(fixture_path(model)), "bytes")
