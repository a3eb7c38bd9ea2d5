"""FastTransformer's int8 serving at full width (dim 192, 6 blocks, 12
heads) in bf16, through the engines: the port's
``UpscalerEngine.calibrate_int8`` against the JAX engine's, and the JAX
outputs that chip_smoke.py holds the card to.

The fixtures, at the smallest input the serving gate takes (8x16 -> 12x24,
one window), with ``compose_tails=True, pallas_serve=True,
attn_impl="fused2", int8_serve=True`` and static scales calibrated the way
bench.py calibrates them (one dynamic pass over the served frame, times 1.1,
bench.py:100-108, which is the JAX engine's ``calibrate_int8`` with
``margin=1.1, floor_frac=0``):

- tests/fixtures/torch_port/int8_tails_x2_bf16.npz: ``int8_scope="tails"``;
- tests/fixtures/torch_port/int8_full_x2_bf16.npz: ``int8_scope="full"``.

Each holds the seed of the weights (``seeded_params``), the input, the JAX
scales (``scale_<name>``, float64; ``(1.0,)`` where the scope quantizes
nothing) and the JAX output. Regenerate them with
``PYTHONPATH=. python tests/test_torch_int8_serve.py`` from the repo root.

Tolerances. Scales: a dynamic scale taken before the trunk (``feat1``,
``feat``) is the maximum of values both sides compute alike, then divided
by 127; the JAX engine runs its forward under ``jit``, where XLA may
multiply by the reciprocal instead: one f32 rounding apart, relative 1e-6
(the scales of an un-jitted JAX forward are equal bit for bit,
tests/test_torch_int8_scopes.py). One taken after it (``combined``,
``dec``) moves with the bf16 roundings of the trunk and the convs, which
sum in other orders (measured below 1.3% at small width, same file):
relative 3%. Outputs: one
int8 step more or less at a quantize moves an output by a few 1e-3; the
interior (4 pixels cropped) is 4 x 16 pixels here, measured max abs 0.0059,
mean abs 0.0013 against the JAX output; bounds ``INT8_LIMIT``, max 1.5e-2
and mean 2.5e-3 (inside the 3e-2 / 3e-3 of the other routes' fixtures),
which chip_smoke.py applies on the card too.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fixtures import DIR, SEED, _assert_fresh
from transformerupscaler_tpu.infer_lib import UpscalerEngine as JaxEngine
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.models.fast_transformer import INT8_TENSORS
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2",
             int8_serve=True)
IN_HW, RES_OUT = (8, 16), (12, 24)
FIXTURES = {scope: os.path.join(DIR, f"int8_{scope}_x2_bf16.npz")
            for scope in ("tails", "full")}
BEFORE_TRUNK = ("feat1", "feat")
INT8_LIMIT = (1.5e-2, 2.5e-3)  # interior max abs, mean abs


def _assert_within(got, want):
    err = np.abs(got - want)[:, 4:-4, 4:-4]
    assert err.max() <= INT8_LIMIT[0] and err.mean() <= INT8_LIMIT[1], (
        err.max(), err.mean())


def _tree(scope):
    model = get_model("FastTransformer", device="cpu", int8_scope=scope,
                      **ROUTE)
    return seeded_params(model, SEED)


def _frames():
    """The served frame, and a second one for a two-frame calibration."""
    return [np.random.default_rng(s).random((1, *IN_HW, 3)).astype(
        np.float32) for s in (SEED, SEED + 1)]


def _scale_arrays(scales) -> dict:
    return {f"scale_{n}": np.asarray(s, np.float64)
            for n, s in zip(INT8_TENSORS, scales)}


def jax_int8(scope) -> dict:
    """The JAX engine on one scope: the fixture's content and, under
    ``calib2``, its default calibration (margin 1.25, dead-channel floor
    0.02) over both frames."""
    x, x2 = _frames()
    engine = JaxEngine("FastTransformer", params={"params": _tree(scope)},
                       dtype=jnp.bfloat16, int8_scope=scope, **ROUTE)
    scales = engine.calibrate_int8(x, res_out=RES_OUT, margin=1.1,
                                   floor_frac=0.0)
    y = engine.upscale(x, res_out=RES_OUT)
    fixture = dict(seed=np.int64(SEED), x=x, y=np.asarray(y, np.float32),
                   res_out=np.asarray(RES_OUT, np.int64),
                   **_scale_arrays(scales))
    calib2 = engine.calibrate_int8([x[0], x2[0]], res_out=RES_OUT)
    return dict(fixture=fixture, calib2=calib2)


@pytest.fixture(scope="module")
def jax_runs():
    return {scope: jax_int8(scope) for scope in FIXTURES}


def load_scales(f) -> tuple:
    return tuple(tuple(f[f"scale_{n}"].tolist()) for n in INT8_TENSORS)


def _check_scales(got, want):
    for name, g, w in zip(INT8_TENSORS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        rel = np.abs(g / w - 1.0).max()
        assert rel <= (1e-6 if name in BEFORE_TRUNK else 0.03), (name, rel)


@pytest.mark.parametrize("scope", sorted(FIXTURES))
def test_int8_fixture_is_fresh(jax_runs, scope):
    """The committed JAX output and scales equal what the JAX engine gives
    now."""
    assert os.path.getsize(FIXTURES[scope]) < 100_000
    _assert_fresh(FIXTURES[scope], jax_runs[scope]["fixture"])


@pytest.mark.parametrize("scope", sorted(FIXTURES))
def test_port_calibrates_and_serves_as_jax(jax_runs, scope):
    """The port's engine calibrated the fixture's way gives the JAX scales
    and, serving with them, the JAX output; its default calibration over
    two frames gives the JAX engine's."""
    want = jax_runs[scope]
    x, x2 = _frames()
    engine = UpscalerEngine("FastTransformer", params=_tree(scope),
                            dtype=torch.bfloat16, device="cpu",
                            int8_scope=scope, **ROUTE)
    scales = engine.calibrate_int8(x, res_out=RES_OUT, margin=1.1,
                                   floor_frac=0.0)
    _check_scales(scales, load_scales(want["fixture"]))
    assert engine.model.int8_scales == scales
    _assert_within(engine.upscale(x, res_out=RES_OUT), want["fixture"]["y"])
    _check_scales(engine.calibrate_int8([x[0], x2[0]], res_out=RES_OUT),
                  want["calib2"])
    report = engine.calibration_check(x2[0], res_out=RES_OUT)
    assert set(report) == {n for n, s in zip(INT8_TENSORS, want["calib2"])
                           if len(s) == 64}
    assert all(r["max_ratio"] <= 0.8 + 1e-6 for r in report.values())


@pytest.mark.parametrize("scope", sorted(FIXTURES))
def test_port_on_cpu_matches_int8_fixture(scope):
    """The check chip_smoke.py makes on the card, here with the plain
    versions: the model built with the file's scales against its output."""
    with np.load(FIXTURES[scope]) as f:
        x, y, scales = f["x"], f["y"], load_scales(f)
        seed = int(f["seed"])
    model = get_model("FastTransformer", device="cpu", dtype=torch.bfloat16,
                      int8_scope=scope, int8_scales=scales, **ROUTE)
    params_from_jax(model, seeded_params(model, seed))
    _assert_within(model(torch.from_numpy(x), res_out=RES_OUT).float()
                   .numpy(), y)


def test_calibration_needs_an_int8_model(tmp_path):
    engine = UpscalerEngine("FastTransformer", dtype=torch.bfloat16,
                            device="cpu", root=str(tmp_path),
                            transformer_dim=32,
                            num_window_blocks=1, num_heads=2,
                            compose_tails=True, pallas_serve=True)
    with pytest.raises(RuntimeError, match="no activation scale"):
        engine.calibrate_int8(_frames()[0], res_out=RES_OUT)
    with pytest.raises(RuntimeError, match="calibrate_int8"):
        engine.calibration_check(_frames()[0], res_out=RES_OUT)


if __name__ == "__main__":
    for scope, path in FIXTURES.items():
        np.savez_compressed(path, **jax_int8(scope)["fixture"])
        print("wrote", path, os.path.getsize(path), "bytes")
