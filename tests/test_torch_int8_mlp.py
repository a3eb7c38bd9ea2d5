"""``int8_mlp``: the window blocks' MLP as two int8 products
(``ops.quant.int8_dense`` with ``quantize_weight``) on WindowTransformer and
FastTransformer, against the JAX package on the CPU.

- ``quantize_weight`` bit for bit; ``int8_dense`` bit for bit with JAX's
  op-by-op evaluation in f32 and in bf16 (its abs-max, scale and quantize in
  the input's dtype).
- The models at a small width (dim 32, 2 blocks, 2 heads), f32 and bf16,
  ``attn_impl`` "xla" and "pallas" (JAX's window-attention kernel in
  interpret mode), against the JAX models with ``int8_mlp``: f32 within
  2e-3 max and 1e-4 mean (a product that lands on the other side of a
  quantization step moves one output by up to 1/127 of its tensor's
  scale: measured 1.1e-3 on FastTransformer "pallas", 3e-7 elsewhere),
  bf16 within the bf16 routes' limit of chip_smoke.py, max 3e-2 and mean
  3e-3 (measured 7.8e-3 and 7.5e-4: two bf16 steps near 1).
- The fused trunks ignore the field, as JAX's ``run_window_trunk`` does:
  "fused2" and "fused" give the output of ``int8_mlp=False`` bit for bit.
- The fixtures chip_smoke.py holds the card to (``window_int8_mlp``,
  ``fast_exact_int8_mlp``): full width, seeded weights, bf16; the port on
  the CPU within chip_smoke.py's bf16 limit (interior max 3e-2, mean 3e-3;
  measured 1.56e-2 and 1.9e-3 on WindowTransformer).

Regenerate the fixtures with ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_int8_mlp.py`` (~1 min).
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops import quant as jax_quant
from transformerupscaler_tpu.ops.pallas import window_attn as jax_window_attn
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.ops.quant import int8_dense, quantize_weight
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
LIMIT = (3e-2, 3e-3)
TOL = {torch.float32: (2e-3, 1e-4), torch.bfloat16: LIMIT}
# name -> (file, model, route, input size, res_out, seed): chip_smoke.py's
# int8_mlp routes.
FIXTURES = {
    "window_int8_mlp": (
        os.path.join(DIR, "window_int8_mlp_bf16.npz"), "WindowTransformer",
        dict(pallas_serve=True, attn_impl="pallas", int8_mlp=True),
        (64, 144), (96, 216), 7),
    "fast_exact_int8_mlp": (
        os.path.join(DIR, "fast_exact_int8_mlp_bf16.npz"), "FastTransformer",
        dict(int8_mlp=True), (24, 144), (36, 216), 7),
}


@pytest.fixture(autouse=True)
def _interpret_window_pallas(monkeypatch):
    monkeypatch.setattr(
        jax_window_attn, "fused_window_attention",
        functools.partial(jax_window_attn.fused_window_attention,
                          interpret=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dense_is_jax(dtype):
    rng = np.random.default_rng(0)
    for trial in range(3):
        x = rng.standard_normal((5, 64, 48)).astype(np.float32) * (trial + 1)
        w = rng.standard_normal((48, 96)).astype(np.float32) / 7
        w[:, 3] = 0.0  # a dead output channel: scale 1
        b = rng.standard_normal(96).astype(np.float32) * 0.1
        jq, js = jax_quant.quantize_weight(jnp.asarray(w))
        tq, ts = quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        want = jax_quant.int8_dense(jnp.asarray(x).astype(JDT[dtype]), jq, js,
                                    jnp.asarray(b))
        got = int8_dense(torch.from_numpy(x).to(dtype), tq, ts,
                         torch.from_numpy(b))
        assert got.dtype == dtype and got.shape == (5, 64, 96)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    no_bias = int8_dense(torch.from_numpy(x).to(dtype), tq, ts)
    want = jax_quant.int8_dense(jnp.asarray(x).astype(JDT[dtype]), jq, js)
    np.testing.assert_array_equal(no_bias.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _both(name, dtype, impl, x, res_out, seed=3):
    model = get_model(name, device="cpu", dtype=dtype, int8_mlp=True,
                      attn_impl=impl, **SMALL)
    tree = seeded_params(model, seed)
    params_from_jax(model, tree)
    got = model(torch.from_numpy(x), res_out=res_out).float().numpy()
    jm = jax_get_model(name, dtype=JDT[dtype], int8_mlp=True, attn_impl=impl,
                       **SMALL)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x),
                               res_out=res_out), np.float32)
    return got, want, model, tree


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["WindowTransformer", "FastTransformer"])
def test_models_with_int8_mlp_match_jax(name, dtype, impl):
    x = np.random.default_rng(1).random((1, 32, 48, 3)).astype(np.float32)
    got, want, model, tree = _both(name, dtype, impl, x, (64, 96))
    assert all(b.int8_mlp for b in model.blocks)
    err = np.abs(got - want)
    assert err.max() <= TOL[dtype][0] and err.mean() <= TOL[dtype][1], (
        err.max(), err.mean())
    # The field changes the output (the int8 MLP runs).
    plain = get_model(name, device="cpu", dtype=dtype, attn_impl=impl,
                      **SMALL)
    params_from_jax(plain, tree)
    assert not np.array_equal(
        plain(torch.from_numpy(x), res_out=(64, 96)).float().numpy(), got)


@pytest.mark.parametrize("impl", ["fused2", "fused"])
@pytest.mark.parametrize("name", ["WindowTransformer", "FastTransformer"])
def test_fused_trunks_ignore_int8_mlp(name, impl):
    x = torch.rand(1, 32, 48, 3, generator=torch.Generator().manual_seed(2))
    outs = []
    for flag in (True, False):
        m = get_model(name, device="cpu", dtype=torch.bfloat16,
                      int8_mlp=flag, attn_impl=impl, **SMALL)
        params_from_jax(m, seeded_params(m, 4))
        outs.append(m(x, res_out=(64, 96)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def jax_int8_mlp_fixture(name, route, in_hw, res_out, seed) -> dict:
    model = get_model(name, device="cpu", dtype=torch.bfloat16, **route)
    tree = seeded_params(model, seed)
    x = np.random.default_rng(seed).random((1, *in_hw, 3)).astype(np.float32)
    jm = jax_get_model(name, dtype=jnp.bfloat16, **route)
    saved = jax_window_attn.fused_window_attention
    jax_window_attn.fused_window_attention = functools.partial(
        saved, interpret=True)
    try:
        y = np.asarray(jm.apply({"params": tree}, jnp.asarray(x),
                                res_out=res_out), np.float32)
    finally:
        jax_window_attn.fused_window_attention = saved
    return dict(seed=np.int64(seed), x=x, y=y,
                res_out=np.asarray(res_out, np.int64))


@pytest.mark.parametrize("which", sorted(FIXTURES))
def test_port_on_cpu_matches_int8_mlp_fixture(which):
    path, name, route, in_hw, res_out, seed = FIXTURES[which]
    assert os.path.getsize(path) < 300_000
    with np.load(path) as f:
        x, y = f["x"], f["y"]
        assert int(f["seed"]) == seed and tuple(f["res_out"]) == res_out
    assert x.shape == (1, *in_hw, 3)
    model = get_model(name, device="cpu", dtype=torch.bfloat16, **route)
    params_from_jax(model, seeded_params(model, seed))
    got = model(torch.from_numpy(x), res_out=res_out).float().numpy()
    err = np.abs(got - y)[:, 4:-4, 4:-4]
    assert err.max() <= LIMIT[0] and err.mean() <= LIMIT[1], (
        err.max(), err.mean())


if __name__ == "__main__":
    for path, *spec in FIXTURES.values():
        np.savez_compressed(path, **jax_int8_mlp_fixture(*spec))
        print("wrote", path, os.path.getsize(path), "bytes")
