"""ResidualTransformer's two JAX switches on the port, against JAX
``_packed_forward`` with the same switch, at narrow width (``RESID_SMALL``,
a 32x32 frame, 2x2 tokens) on the CPU:

- ``TUX_RESID_DEC_PALLAS=0``: ``decoder_conv1`` as the XLA conv, so the
  stream conv serves conv2 alone (one call a frame, not two);
- ``TUX_RESID_BICUBIC=conv``: both bicubic branches as the pre-shuffle
  bicubic conv (``ops.resize.bicubic_upscale_conv``), the phase
  permutation and the two pixel shuffles.

The JAX outputs of the served route (``packed_serve``, ``pallas_serve``,
``attn_impl="fused2"``; its conv2 and attention run the Pallas kernels in
interpret mode) are committed in
``tests/fixtures/torch_port/resid_switches_small.npz``;
``test_fixture_is_fresh`` recomputes them with JAX, bit for bit, and
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_resid_switches.py``
rewrites them. The all-XLA packed route (``pallas_serve`` off) is held
against JAX directly. f32 at the parity bound (atol 5e-5, rtol 1e-4); bf16
within two bf16 steps of an output in [0, 1] (7.8e-3), mean 1e-4 (measured:
3.9e-3 and 1.3e-6 with the stream conv's plain version).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.models import residual_transformer as RT
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params
from transformerupscaler_tpu.registry import get_model as jax_get_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "resid_switches_small.npz")
RESID_SMALL = dict(transformer_dim=32, num_transformer_blocks=2, num_heads=2,
                   token_hw=(2, 2))
SERVE = dict(packed_serve=True, pallas_serve=True, attn_impl="fused2")
XLA = dict(packed_serve=True)
SWITCHES = {"dec_xla": {"TUX_RESID_DEC_PALLAS": "0"},
            "bicubic_conv": {"TUX_RESID_BICUBIC": "conv"}}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SEED, SCALE = 3, 2
TOL = dict(atol=5e-5, rtol=1e-4)
BF16_LIMIT = (2 * 2.0 ** -8, 1e-4)


def _x() -> np.ndarray:
    return np.random.default_rng(7).random((1, 32, 32, 3)).astype(np.float32)


def _tree():
    return seeded_params(get_model("ResidualTransformer", device="cpu",
                                   **RESID_SMALL), SEED)


def jax_out(switch, dtype, route, x, scale=SCALE) -> np.ndarray:
    old = {k: os.environ.get(k) for k in SWITCHES[switch]}
    os.environ.update(SWITCHES[switch])
    try:
        jm = jax_get_model("ResidualTransformer", dtype=DTYPES[dtype][1],
                           **RESID_SMALL, **route)
        y = jm.apply({"params": _tree()}, jnp.asarray(x),
                     upscale_factor=scale)
        return np.asarray(y.astype(jnp.float32))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_out(switch, dtype, route, x, monkeypatch, scale=SCALE):
    """The port's output with the switch set, and its conv3x3_stream calls."""
    calls = []
    real = RT.conv3x3_stream

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(RT, "conv3x3_stream", counting)
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    model = get_model("ResidualTransformer", device="cpu",
                      dtype=DTYPES[dtype][0], **RESID_SMALL, **route)
    params_from_jax(model, _tree())
    y = model(torch.from_numpy(x), upscale_factor=scale)
    return y.float().numpy(), len(calls)


def write_fixture() -> dict:
    x = _x()
    out = {"x": x, "seed": np.int64(SEED), "scale": np.int64(SCALE)}
    for switch in SWITCHES:
        for dtype in DTYPES:
            out[f"{switch}_{dtype}"] = jax_out(switch, dtype, SERVE, x)
    return out


def _check(got, want, dtype):
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        err = np.abs(got - want)
        assert err.max() <= BF16_LIMIT[0] and err.mean() <= BF16_LIMIT[1], \
            (err.max(), err.mean())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_served_route_with_the_switch_matches_jax(switch, dtype,
                                                  monkeypatch):
    with np.load(FIXTURE) as f:
        x, want = f["x"], f[f"{switch}_{dtype}"]
    got, calls = port_out(switch, dtype, SERVE, x, monkeypatch)
    _check(got, want, dtype)
    assert got.shape == (1, 64, 64, 3)
    # The stream conv serves conv2 and, unless DEC_PALLAS=0, decoder_conv1.
    assert calls == (1 if switch == "dec_xla" else 2)


def test_xla_route_bicubic_conv_matches_jax(monkeypatch):
    """The all-XLA packed route at x3 in f32 (JAX reads
    TUX_RESID_DEC_PALLAS only under pallas_serve): no stream conv, the
    bicubic conv."""
    x = _x()
    got, calls = port_out("bicubic_conv", "f32", XLA, x, monkeypatch, 3)
    _check(got, jax_out("bicubic_conv", "f32", XLA, x, 3), "f32")
    assert calls == 0 and got.shape == (1, 96, 96, 3)


def test_switches_change_the_route(monkeypatch):
    """Each switch takes another computation than the default route (not
    a no-op): the outputs differ by rounding only, in f32."""
    x = _x()
    model = get_model("ResidualTransformer", device="cpu", **RESID_SMALL,
                      **SERVE)
    params_from_jax(model, _tree())
    default = model(torch.from_numpy(x), upscale_factor=SCALE).numpy()
    for switch in SWITCHES:
        got, _ = port_out(switch, "f32", SERVE, x, monkeypatch)
        np.testing.assert_allclose(got, default, **TOL)
        for k in SWITCHES[switch]:
            monkeypatch.delenv(k)
    got, _ = port_out("bicubic_conv", "f32", SERVE, x, monkeypatch)
    assert not np.array_equal(got, default)


def test_fixture_is_fresh():
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    fresh = write_fixture()
    assert set(stored) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **write_fixture())
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")
