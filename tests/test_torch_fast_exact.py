"""FastTransformer's exact path and JAX's routing in the port, against the
JAX package on the CPU (f32: tests/test_parity.py's atol=5e-5, rtol=1e-4,
on the whole frame, the border included).

- The default engine: the port's ``UpscalerEngine("FastTransformer")`` and
  the JAX engine built the same way (f32, ``attn_impl="xla"``, no serve
  flags) on the same seeded weights at a small trunk (the JAX engine takes
  no width fields, so its model is swapped for the small one it would
  build), at x2, x3, x6, a squashed ``res_out`` and a geometry outside the
  serving gate.
- ``compose_tails=True`` outside the gate: JAX ``__call__`` with its
  composed tails (x2 and the two-stage x4).
- ``fix_ratio_bug=True`` on the exact path and on the serving forward
  (Pallas interpret mode on the JAX side, the plain versions here).
- fast_exact_f32.npz: the JAX default engine's f32 output at full model
  width (dim 192, 6 blocks, 12 heads) on a 20x36 frame squashed to 30x54
  (the features reflect-padded to 24x40), which ``chip_smoke.py`` holds the
  port to on the card. Regenerate with ``PYTHONPATH=. python
  tests/test_torch_fast_exact.py`` from the repo root.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerupscaler_tpu.infer_lib import UpscalerEngine as JaxEngine
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch import kernels as K
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

TOL = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
SEED = 3
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_port", "fast_exact_f32.npz")
FIXTURE_SEED, FIXTURE_HW, FIXTURE_RES_OUT = 7, (20, 36), (30, 54)


def _frame(hw, seed=1):
    return np.random.default_rng(seed).random((*hw, 3)).astype(np.float32)


def _small_tree():
    return seeded_params(get_model("FastTransformer", device="cpu", **SMALL),
                         SEED)


@pytest.mark.parametrize("hw,call", [
    ((16, 32), dict(upscale_factor=2)),
    ((16, 32), dict(upscale_factor=3)),
    ((16, 16), dict(upscale_factor=6)),
    ((16, 32), dict(res_out=(24, 48))),
    ((12, 32), dict(upscale_factor=2)),
], ids=["x2", "x3", "x6", "squash", "outside_gate"])
def test_default_engine_matches_jax_engine(hw, call):
    tree = _small_tree()
    port = UpscalerEngine("FastTransformer", params=tree, device="cpu",
                          **SMALL)
    assert not (port.model.compose_tails or port.model.pallas_serve
                or port.model.packed_serve or port.model.fix_ratio_bug)
    jax_engine = JaxEngine("FastTransformer", params={"params": tree})
    jax_engine.model = jax_get_model("FastTransformer", **SMALL)
    x = _frame(hw)
    K.reset_launches()
    got = port.upscale(x, **call)
    want = jax_engine.upscale(x, **call)
    assert not any(K.LAUNCHES.values())
    assert got.shape == want.shape
    assert 0.2 < np.mean((want > 0) & (want < 1))  # not all clipped
    np.testing.assert_allclose(got, want, **TOL)


def _both(x, call, **config):
    """(port output, JAX ``apply`` output) of one model configuration at
    the small trunk, same weights."""
    model = get_model("FastTransformer", device="cpu", **SMALL, **config)
    tree = seeded_params(model, SEED)
    params_from_jax(model, tree)
    got = model(torch.from_numpy(x[None]), **call).numpy()
    jm = jax_get_model("FastTransformer", **SMALL, **config)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x[None]),
                               **call))
    assert got.shape == want.shape
    return got, want


def test_compose_tails_outside_the_gate_matches_jax():
    """Serve flags at a height that is no multiple of 8: both sides run
    ``__call__`` with the composed tails (the border ring of the
    composition included)."""
    for hw, call in (((12, 32), dict(upscale_factor=2)),
                     ((12, 20), dict(upscale_factor=4)),
                     ((12, 32), dict(res_out=(18, 48)))):
        got, want = _both(_frame(hw), call, compose_tails=True,
                          pallas_serve=True)
        np.testing.assert_allclose(got, want, **TOL)


SERVE = dict(compose_tails=True, pallas_serve=True)


@pytest.mark.parametrize("route,fix,shape", [
    ({}, False, (1, 16, 32, 3)), ({}, True, (1, 16, 16, 3)),
    (SERVE, True, (1, 16, 16, 3))], ids=["exact", "exact_fixed", "serve_fixed"])
def test_fix_ratio_bug_matches_jax(route, fix, shape):
    """8x16 asked for 16x16: the reference's (H, H) compare takes it for
    the x2 extent and skips the squash; ``fix_ratio_bug`` squashes, on the
    exact path and on the serving forward (which without the fix is the
    identity case of tests/test_torch_fast_transformer.py)."""
    got, want = _both(_frame((8, 16)), dict(res_out=(16, 16)),
                      fix_ratio_bug=fix, **route)
    assert got.shape == shape
    np.testing.assert_allclose(got, want, **TOL)


def jax_fast_exact() -> dict:
    """The JAX default engine at full width on the fixture's frame."""
    model = get_model("FastTransformer", device="cpu")
    tree = seeded_params(model, FIXTURE_SEED)
    x = _frame(FIXTURE_HW, FIXTURE_SEED)
    y = JaxEngine("FastTransformer", params={"params": tree}).upscale(
        x, res_out=FIXTURE_RES_OUT)
    return dict(seed=np.int64(FIXTURE_SEED), x=x[None], y=y[None],
                res_out=np.asarray(FIXTURE_RES_OUT, np.int64))


def test_fast_exact_fixture_is_fresh():
    """The committed JAX output equals what the JAX engine gives now."""
    assert os.path.getsize(FIXTURE) < 100_000
    fresh = jax_fast_exact()
    with np.load(FIXTURE) as f:
        assert set(f.files) == set(fresh)
        for k in fresh:
            np.testing.assert_allclose(f[k], fresh[k], atol=1e-6, rtol=0,
                                       err_msg=k)


def test_port_on_cpu_matches_fast_exact_fixture(tmp_path):
    """The check chip_smoke.py makes on the card: the default engine at
    full width, whole frame, on the fixture's seeded weights (``root``
    holds no checkpoint)."""
    with np.load(FIXTURE) as f:
        seed, x, y = int(f["seed"]), f["x"], f["y"]
    engine = UpscalerEngine("FastTransformer", device="cpu", seed=seed,
                            root=str(tmp_path))
    got = engine.upscale(x, res_out=FIXTURE_RES_OUT)
    assert got.shape == y.shape == (1, *FIXTURE_RES_OUT, 3)
    np.testing.assert_allclose(got, y, **TOL)


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **jax_fast_exact())
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")
