"""WindowTransformer, ResidualTransformer and BicubicInterpolation of the port
against the JAX models on the CPU: the exact paths and every served route at
small geometries (f32: tests/test_parity.py's atol=5e-5, rtol=1e-4; bf16
bounds stated at the tests), the reference's golden outputs of all three
trained models (tests/golden/*.npz), and the committed trained checkpoints
carried across with ``params_from_jax``.

Where a JAX route reaches a Pallas kernel it runs in interpret mode, as the
JAX package's own tests run it; the port's wrappers compute their plain
versions on CPU tensors. ``window_attention(impl="pallas")`` of the JAX package
does not pass ``interpret`` on, so the tests put the interpreted kernel in its
place, as tests/test_pallas.py calls it.
"""

import functools

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.checkpoint import load_checkpoint
from transformerupscaler_tpu.ops.pallas import window_attn as jax_window_attn
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_tpu.tools.torch_convert import convert_state_dict
from transformerupscaler_torch import kernels as K
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.registry import get_model, list_models
from transformerupscaler_torch.weights import params_from_jax, seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=5e-5, rtol=1e-4)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
WINDOW_SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
RESID_SMALL = dict(transformer_dim=32, num_transformer_blocks=2, num_heads=2,
                   token_hw=(2, 2))
WINDOW_SERVE = dict(pallas_serve=True, attn_impl="pallas")
RESID_SERVE = dict(packed_serve=True, pallas_serve=True, attn_impl="fused2")


@pytest.fixture(autouse=True)
def _interpret_window_pallas(monkeypatch):
    monkeypatch.setattr(
        jax_window_attn, "fused_window_attention",
        functools.partial(jax_window_attn.fused_window_attention,
                          interpret=True))


def _both(name, x, call, dtype=torch.float32, seed=3, **config):
    """(port output, JAX output) as float32 numpy, same seeded weights."""
    model = get_model(name, device="cpu", dtype=dtype, **config)
    tree = seeded_params(model, seed)
    params_from_jax(model, tree)
    got = model(torch.from_numpy(x), **call).float().numpy()
    jm = jax_get_model(name, dtype=JDT[dtype], **config)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), **call)
                      .astype(jnp.float32))
    return got, want


# ---------------------------------------------------------------- window
@pytest.mark.parametrize("route", [{}, WINDOW_SERVE], ids=["exact", "serve"])
@pytest.mark.parametrize("hw,call", [
    ((48, 80), dict(res_out=(72, 120))),        # 3x5 tokens: padded window
    ((50, 70), dict(upscale_factor=2)),         # floors, crops; gate misses
], ids=["gate", "odd"])
def test_window_transformer_matches_jax_f32(rng, route, hw, call):
    x = rng.random((1, *hw, 3)).astype(np.float32)
    K.reset_launches()
    got, want = _both("WindowTransformer", x, call, **WINDOW_SMALL, **route)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    assert not any(K.LAUNCHES.values())


def test_window_transformer_serve_bf16_close_to_jax(rng):
    """bf16 on the served route: eight-bit mantissas through two blocks and
    two bicubic passes; the residual branch is small beside the upscaled
    input (``seeded_params``), so single roundings of the output in [0, 1]
    dominate: max abs <= 3e-2, mean abs <= 3e-3, the limits of the
    FastTransformer routes."""
    x = rng.random((1, 48, 80, 3)).astype(np.float32)
    got, want = _both("WindowTransformer", x, dict(res_out=(72, 120)),
                      torch.bfloat16, **WINDOW_SMALL, **WINDOW_SERVE)
    err = np.abs(got - want)
    assert err.max() <= 3e-2 and err.mean() <= 3e-3, (err.max(), err.mean())


# -------------------------------------------------------------- residual
@pytest.mark.parametrize("res_out", [(64, 64), (96, 96), (128, 128),
                                     (192, 192), (48, 48)],
                         ids=["x2", "x3", "x4", "x6", "x1.5"])
@pytest.mark.parametrize("route", [{}, RESID_SERVE], ids=["exact", "serve"])
def test_residual_transformer_matches_jax_f32(rng, route, res_out):
    """Integer scales take ``_packed_forward`` on the served route; 1.5 falls
    through to the exact path on both sides, still with the attention
    kernel's branch."""
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    got, want = _both("ResidualTransformer", x, dict(res_out=res_out),
                      **RESID_SMALL, **route)
    assert got.shape == (1, *res_out, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_residual_transformer_serve_bf16_close_to_jax(rng):
    """Same limits and reasons as the WindowTransformer bf16 case."""
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    got, want = _both("ResidualTransformer", x, dict(res_out=(64, 64)),
                      torch.bfloat16, **RESID_SMALL, **RESID_SERVE)
    err = np.abs(got - want)
    assert err.max() <= 3e-2 and err.mean() <= 3e-3, (err.max(), err.mean())


def test_residual_transformer_rejects_another_token_grid(rng, monkeypatch):
    model = get_model("ResidualTransformer", device="cpu", **RESID_SMALL,
                      **RESID_SERVE)
    x = torch.zeros(1, 32, 48, 3)
    with pytest.raises(ValueError, match="token grid"):
        model(x, res_out=(64, 96))   # served route
    with pytest.raises(ValueError, match="token grid"):
        model(x, res_out=(48, 72))   # exact route
    # The served route's switch TUX_RESID_BICUBIC=conv serves as JAX does
    # (tests/test_torch_resid_switches.py holds both switches).
    monkeypatch.setenv("TUX_RESID_BICUBIC", "conv")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port",
                              "resid_switches_small.npz")) as f:
        x, want, seed = f["x"], f["bicubic_conv_f32"], int(f["seed"])
    params_from_jax(model, seeded_params(model, seed))
    got = model(torch.from_numpy(x), res_out=(64, 64)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------- bicubic
def test_bicubic_matches_jax_and_engine_resolves_scale(rng):
    assert list_models() == ["BicubicInterpolation", "FastTransformer",
                             "ResidualTransformer", "WindowTransformer"]
    x = rng.random((1, 20, 28, 3)).astype(np.float32)
    got, want = _both("BicubicInterpolation", x, dict(res_out=(30, 42)))
    np.testing.assert_allclose(got, want, **TOL)
    engine = UpscalerEngine("BicubicInterpolation", device="cpu",
                            dtype=torch.bfloat16, attn_impl="fused2")
    img = (x[0] * 255).astype(np.uint8)
    out = engine.upscale(img, upscale_factor=2)
    assert out.shape == (40, 56, 3) and out.dtype == np.float32
    np.testing.assert_allclose(
        engine.upscale(img, res_out=(30, 42), require_ratio=False),
        _both("BicubicInterpolation", img[None].astype(np.float32) / 255,
              dict(res_out=(30, 42)))[1][0], **TOL)


def test_registry_routes_of_the_new_models():
    """Served routes build, the fused trunks and ``int8_mlp`` included; the
    ones that need kernels the port lacks raise by name; FastTransformer's
    serving flags are accepted and ignored."""
    for impl in ("fused", "fused2"):
        w = get_model("WindowTransformer", device="cpu", attn_impl=impl,
                      int8_trunk=True, **WINDOW_SMALL)
        assert w.attn_impl == impl and not w.int8_trunk
    w = get_model("WindowTransformer", device="cpu", int8_mlp=True,
                  **WINDOW_SMALL)
    assert w.int8_mlp and all(b.int8_mlp for b in w.blocks)
    for flags in (dict(pallas_serve=False, packed_serve=False),
                  dict(pallas_serve=True, packed_serve=True,
                       compose_tails=True, dropout=0.1, split_tail=None)):
        w = get_model("WindowTransformer", device="cpu", **flags,
                      **WINDOW_SMALL)
        r = get_model("ResidualTransformer", device="cpu", attn_impl="fused",
                      **flags, **RESID_SMALL)
        assert w.pallas_serve == r.pallas_serve == flags["pallas_serve"]
        assert r.packed_serve == flags["packed_serve"]
    with pytest.raises(TypeError):
        get_model("WindowTransformer", device="cpu", no_such_field=1)


# ----------------------------------------------------------------- golden
def _load_golden(name):
    data = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
    meta = json.loads(bytes(data["meta"]).decode())
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd:")}
    x = np.random.default_rng(meta["x_seed"]).random(
        tuple(meta["x_shape"]), dtype=np.float64).astype(np.float32)
    return sd, x, data["y"], meta


@pytest.mark.parametrize("case,name", [
    ("window_resout", "WindowTransformer"),
    ("window_odd", "WindowTransformer"),
    ("residual_default", "ResidualTransformer"),
    ("fast_resout_nosquash", "FastTransformer"),
    ("fast_resout_squash", "FastTransformer"),
    ("fast_upscale3", "FastTransformer"),
    ("fast_upscale6", "FastTransformer")])
def test_golden_parity(case, name):
    """The reference PyTorch models' own outputs: the state_dict goes through
    the JAX package's converter and ``params_from_jax`` into the port.
    FastTransformer's goldens (base_channels 8) take its default fields, the
    exact path, as tests/test_parity.py runs them in JAX."""
    sd, x_nchw, y_nchw, meta = _load_golden(case)
    model = get_model(name, device="cpu", **meta["config"])
    params_from_jax(model, convert_state_dict(sd, name))
    call = dict(meta["call"])
    if "res_out" in call:
        call["res_out"] = tuple(call["res_out"])
    out = model(torch.from_numpy(x_nchw.transpose(0, 2, 3, 1).copy()), **call)
    np.testing.assert_allclose(out.numpy().transpose(0, 3, 1, 2), y_nchw,
                               **TOL)


# ------------------------------------------------------- trained weights
def _demo_crop(name, h, w):
    img = Image.open(os.path.join(ROOT, "models", name, "demo",
                                  "input.png")).convert("RGB")
    x = np.asarray(img, np.float32)[None] / 255.0
    return np.ascontiguousarray(x[:, :h, :w])


@pytest.mark.parametrize("name,epoch,crop,call,config", [
    ("WindowTransformer", 40, (64, 96), dict(upscale_factor=2), {}),
    ("FastTransformer", 100, (32, 64), dict(res_out=(48, 96)),
     dict(compose_tails=True, pallas_serve=True, split_tail=False,
          attn_impl="xla")),
    ("ResidualTransformer", 17, (720, 1280), dict(res_out=(1080, 1920)), {}),
])
def test_trained_checkpoint_carries_across(name, epoch, crop, call, config):
    """The committed Orbax checkpoint, restored by the JAX package, fits the
    port's model leaf for leaf (``params_from_jax`` raises on a missing or
    leftover one) and gives the JAX model's output at f32 on a crop of the
    model's demo input. ResidualTransformer's ``pos_embed`` fixes the full
    720x1280 frame."""
    path = os.path.join(ROOT, "models", name, "checkpoints",
                        f"model_epoch_{epoch}")
    params = load_checkpoint(path, name)["params"]
    model = get_model(name, device="cpu", **config)
    params_from_jax(model, params)
    x = _demo_crop(name, *crop)
    got = model(torch.from_numpy(x), **call).numpy()
    want = np.asarray(jax_get_model(name, **config).apply(
        {"params": params}, jnp.asarray(x), **call))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
