"""The banded resize (transformerupscaler_torch/ops/resize.py) against the
JAX package's (ops/resize.py:113-284) on the CPU.

- ``_banded_factors``: the weights and the starts equal JAX's array for
  array at the serving geometries, and None where JAX's is;
- ``_banded_on``: JAX's gate over ``TUX_BANDED_RESIZE`` unset / "auto" /
  "0" / "1", float32 / bfloat16, a precision asked for or not;
- ``resize_shuffled`` and ``resize`` on their banded arms against JAX's
  banded arms: float32 at tests/test_parity.py's atol=5e-5, rtol=1e-4, and
  bfloat16 under "1" within one bf16 step of the output plus one carried
  from the height pass, which each side rounds to bf16 (rtol 2^-7, atol
  2^-7 of the largest value);
- FastTransformer's exact float32 ``__call__`` (dim 32, 2 blocks, 2 heads)
  on a 184x320 frame to 276x480, where both squash passes band, against
  the JAX model;
- which squash the serving forward asks for: ``precise`` exactly where JAX
  passes a precision (the "squash" part of ``serve_quality``), by spies on
  both sides (JAX traced with ``jax.eval_shape``, no Pallas forward);
- the gradient through the banded arms equals the dense arms' (float32).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerupscaler_tpu.models.fast_transformer as jax_ft
from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.models import fast_transformer as FT
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

# The modules (each package's ``ops`` exports a function ``resize``).
J = importlib.import_module("transformerupscaler_tpu.ops.resize")
R = importlib.import_module("transformerupscaler_torch.ops.resize")
F32 = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
ENV = "TUX_BANDED_RESIZE"

# (in, r, out): the squash at 720p -> 1080p (both passes), x3 to 1080p,
# x4 at 264x480, the fixtures' 180x320 -> 270x480 and the model test's.
BANDED = [(720, 2, 1080), (1280, 2, 1920), (360, 3, 1080), (264, 4, 1056),
          (180, 2, 270), (320, 2, 480), (184, 2, 276)]
DENSE = [(96, 2, 144), (16, 2, 24), (180, 1, 120), (8, 3, 300)]


@pytest.mark.parametrize("geom", BANDED + DENSE,
                         ids=[f"{i}x{r}-{o}" for i, r, o in BANDED + DENSE])
def test_banded_factors_equal_jax(geom):
    i, r, o = geom
    args = (i, o, "bilinear", True, None, 128, r)
    got, want = R._banded_factors(*args), J._banded_factors(*args)
    assert (got is None) == (want is None) == (geom in DENSE)
    if want is not None:
        assert got[0].dtype == want[0].dtype == np.float32
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_banded_factors_equal_jax_bicubic():
    """``resize``'s factors (r = 1): PyTorch's bicubic upscale and the
    antialiased bilinear downscale."""
    for args in ((180, 360, "bicubic", False, None, 128),
                 (360, 270, "bilinear", True, None, 128)):
        got, want = R._banded_factors(*args), J._banded_factors(*args)
        assert want is not None
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("env", [None, "auto", "0", "1"])
def test_gate_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        for precise in (False, True):
            prec = jax.lax.Precision.HIGH if precise else None
            assert R._banded_on(precise, tdt) == J._banded_on(prec, jdt), (
                env, tdt, precise)
    assert R._banded_on() == J._banded_on()


def _z(shape, seed=0):
    return np.random.default_rng(seed).random(shape, np.float32)


def _both_shuffled(z, r, out_hw, tdt, jdt):
    got = R.resize_shuffled(torch.from_numpy(z).to(tdt), r, out_hw)
    want = J.resize_shuffled(jnp.asarray(z, jdt), r, out_hw)
    return got.float().numpy(), np.asarray(want, np.float32)


def _bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("shape,r", [((1, 180, 320, 12), 2),
                                     ((1, 180, 320, 27), 3)],
                         ids=["x2", "x3"])
def test_resize_shuffled_banded_matches_jax(monkeypatch, shape, r):
    _, h, w, _ = shape
    for n in (h, w):
        assert J._banded_factors(n, n * 3 // 2, "bilinear", True, None, 128,
                                 r) is not None
    z = _z(shape)
    monkeypatch.delenv(ENV, raising=False)  # "auto": f32 bands
    got, want = _both_shuffled(z, r, (270, 480), torch.float32, jnp.float32)
    assert got.shape == want.shape == (1, 270, 480, shape[3] // (r * r))
    np.testing.assert_allclose(got, want, **F32)
    monkeypatch.setenv(ENV, "1")
    got, want = _both_shuffled(z, r, (270, 480), torch.bfloat16, jnp.bfloat16)
    _bf16_close(got, want)


def test_resize_banded_matches_jax(monkeypatch):
    """``resize`` under "1": the bicubic x2 upscale and the antialiased
    bilinear downscale, f32 and bf16."""
    monkeypatch.setenv(ENV, "1")
    x = _z((1, 180, 320, 3), 1)
    for fn, args, out in ((R.interpolate_bicubic, (x,), (360, 640)),
                          (R.resize_antialias_bilinear,
                           (_z((1, 360, 640, 3), 2),), (270, 480))):
        jfn = getattr(J, fn.__name__)
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            got = fn(torch.from_numpy(args[0]).to(tdt), out).float().numpy()
            want = np.asarray(jfn(jnp.asarray(args[0], jdt), out), np.float32)
            assert got.shape == want.shape == (1, *out, 3)
            if tdt == torch.float32:
                np.testing.assert_allclose(got, want, **F32)
            else:
                _bf16_close(got, want)


def test_resize_dense_unless_forced(monkeypatch):
    """"auto" leaves ``resize`` dense and "0" every squash: the banded arm
    is not reached (its device copies are not asked for)."""
    calls = []
    real = R._band_on
    monkeypatch.setattr(R, "_band_on", lambda *a: (calls.append(a),
                                                   real(*a))[1])
    x = torch.from_numpy(_z((1, 180, 320, 12)))
    monkeypatch.delenv(ENV, raising=False)
    R.interpolate_bicubic(x[..., :3], (360, 640))
    R.resize_shuffled(x.bfloat16(), 2, (270, 480))
    monkeypatch.setenv(ENV, "0")
    R.resize_shuffled(x, 2, (270, 480), precise=True)
    assert calls == []
    monkeypatch.setenv(ENV, "auto")
    R.resize_shuffled(x.bfloat16(), 2, (270, 480), precise=True)
    assert len(calls) == 2


def test_fast_exact_f32_banded_matches_jax(monkeypatch):
    """FastTransformer's exact path in f32 at dim 32 on 184x320 to 276x480:
    x2, then the squash, both of whose passes band under "auto"."""
    monkeypatch.delenv(ENV, raising=False)
    model = get_model("FastTransformer", device="cpu", **SMALL)
    tree = seeded_params(model, 3)
    params_from_jax(model, tree)
    x = _z((1, 184, 320, 3), 4)
    banded = []
    real = R._band_on
    monkeypatch.setattr(R, "_band_on", lambda *a: (banded.append(a[:3]),
                                                   real(*a))[1])
    got = model(torch.from_numpy(x), res_out=(276, 480)).numpy()
    assert banded == [(184, 2, 276), (320, 2, 480)]
    jm = jax_ft.FastTransformer(**SMALL)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x),
                               res_out=(276, 480)))
    assert got.shape == want.shape == (1, 276, 480, 3)
    assert 0.2 < np.mean((want > 0) & (want < 1))  # not all clipped
    np.testing.assert_allclose(got, want, **F32)


ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="xla")
# (label, dtype, fields): the exact path in both dtypes, bench.py's route,
# serve_quality with its default "tails" part (f32 tails: an f32 squash),
# with "tails,squash" and with "squash" alone (a bf16 squash at HIGH).
SQUASH_ROUTES = [
    ("exact-f32", "float32", {}),
    ("exact-bf16", "bfloat16", {}),
    ("bench", "bfloat16", ROUTE),
    ("quality-tails", "bfloat16", dict(ROUTE, serve_quality=True)),
    ("quality-tails,squash", "bfloat16",
     dict(ROUTE, serve_quality=True, quality_parts="tails,squash")),
    ("quality-squash", "bfloat16",
     dict(ROUTE, serve_quality=True, quality_parts="squash")),
]
IN_HW, RES_OUT = (16, 64), (24, 96)


@pytest.mark.parametrize("case", SQUASH_ROUTES, ids=[c[0] for c in SQUASH_ROUTES])
def test_squash_asks_what_jax_asks(monkeypatch, case):
    """The squash's dtype and ``precise`` flag on every route, against
    the JAX model's ``resize_shuffled`` dtype and precision (traced); so
    "auto" bands the same squashes on both sides."""
    _, dtype, fields = case
    monkeypatch.delenv(ENV, raising=False)
    seen = {"port": [], "jax": []}
    real = FT.resize_shuffled

    def port_spy(z, r, out_hw, *a, precise=False, **k):
        seen["port"].append((str(z.dtype).split(".")[-1], precise,
                             R._banded_on(precise, z.dtype)))
        return real(z, r, out_hw, *a, precise=precise, **k)

    jreal = jax_ft.resize_shuffled

    def jax_spy(z, r, out_hw, *a, precision=None, **k):
        seen["jax"].append((jnp.dtype(z.dtype).name, precision is not None,
                            J._banded_on(precision, z.dtype)))
        return jreal(z, r, out_hw, *a, precision=precision, **k)

    monkeypatch.setattr(FT, "resize_shuffled", port_spy)
    monkeypatch.setattr(jax_ft, "resize_shuffled", jax_spy)
    model = get_model("FastTransformer", device="cpu",
                      dtype=getattr(torch, dtype), **SMALL, **fields)
    tree = seeded_params(model, 3)
    params_from_jax(model, tree)
    x = _z((1, *IN_HW, 3), 5)
    model(torch.from_numpy(x), res_out=RES_OUT)
    jm = jax_ft.FastTransformer(dtype=jnp.dtype(dtype), **SMALL, **fields)
    jax.eval_shape(lambda p, v: jm.apply(p, v, res_out=RES_OUT),
                   {"params": tree}, jnp.asarray(x))
    assert len(seen["port"]) == 1 and seen["port"] == seen["jax"], seen


def test_banded_gradient_equals_dense(monkeypatch):
    """Autograd through the banded arms (the f32 Trainer under "1"): the
    gradient of a weighted sum of the squash equals the dense arms'."""
    z0 = torch.from_numpy(_z((2, 180, 320, 12), 6))
    g = torch.from_numpy(_z((2, 270, 480, 3), 7)) - 0.5
    grads = {}
    for env in ("0", "1"):
        monkeypatch.setenv(ENV, env)
        z = z0.clone().requires_grad_(True)
        (R.resize_shuffled(z, 2, (270, 480)) * g).sum().backward()
        grads[env] = z.grad.numpy()
    assert np.abs(grads["1"]).max() > 0.1
    np.testing.assert_allclose(grads["1"], grads["0"], **F32)
