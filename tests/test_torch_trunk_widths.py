"""The fused trunk at the widths and in the modes its kernel gained, on the
CPU, where the wrapper computes its plain version
(transformerupscaler_torch/kernels/trunk2.py), against the JAX kernels in
Pallas interpret mode: mode "v2" at WindowTransformer's width (C=128, 8 heads
of 16) against ``trunk2.fused_window_trunk_v2``, and mode "v1" at C=128 and
C=192 against ``trunk.fused_window_trunk`` (the residual adds associated as
(x + attn) + b). Two windows, two layers, weights from a numpy seed; each
JAX kernel runs once per module.

Then WindowTransformer on its fused routes: at a small width at f32 against
the JAX model, and at full width in bf16 against the committed JAX output
``tests/fixtures/torch_port/window_fused2_bf16.npz`` (``attn_impl="fused2"``,
``pallas_serve=True``, 16x16 -> 24x24: one token, one window, the smallest
input the stream conv's gate takes), which ``chip_smoke.py`` holds the card
to. Regenerate it with ``PYTHONPATH=. python
tests/test_torch_trunk_widths.py`` from the repo root.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_fixtures import DIR, _assert_fresh, jax_fixture
from transformerupscaler_tpu.ops.pallas.trunk import (
    fused_window_trunk as jax_fused_window_trunk,
)
from transformerupscaler_tpu.ops.pallas.trunk2 import fused_window_trunk_v2
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.kernels import trunk2 as T
from transformerupscaler_torch.models.common import WindowBlock
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

WS, LAYERS, N_WIN = 8, 2, 2
CASES = [(128, "v2"), (128, "v1"), (192, "v1")]
WINDOW_FUSED2 = (os.path.join(DIR, "window_fused2_bf16.npz"),
                 "WindowTransformer",
                 dict(pallas_serve=True, attn_impl="fused2"), (16, 16),
                 (24, 24))


class Trunk(nn.Module):
    def __init__(self, dim, layers=LAYERS):
        super().__init__()
        self.blocks = nn.ModuleList(WindowBlock(dim, WS, dim // 16)
                                    for _ in range(layers))


def _case(dim):
    trunk = Trunk(dim)
    tree = seeded_params(trunk, dim)
    params_from_jax(trunk, tree)
    win = np.random.default_rng(dim).standard_normal(
        (N_WIN, WS * WS, dim)).astype(np.float32)
    return trunk, tree, win


@pytest.fixture(scope="module")
def jax_trunks():
    """(dim, mode, dtype) -> the JAX kernel's output, f32 numpy."""
    out = {}
    for dim, mode in CASES:
        _, tree, win = _case(dim)
        blocks = [tree[f"blocks_{i}"] for i in range(LAYERS)]
        fn = fused_window_trunk_v2 if mode == "v2" else jax_fused_window_trunk
        for dt in ("float32", "bfloat16"):
            out[dim, mode, dt] = np.asarray(fn(
                jnp.asarray(win).astype(dt), blocks, dim // 16, WS,
                interpret=True), np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,mode", CASES, ids=[f"{d}-{m}" for d, m in CASES])
def test_trunk_plain_matches_pallas(jax_trunks, dim, mode, dtype):
    """f32: atol=5e-5, rtol=1e-4 (test_torch_fused_trunk.py's bound, which
    also covers the JAX bodies' rational erf, 1.5e-7). bf16: both sides
    round at the same points, but one element that rounds the other way
    shifts its token's next product by a fraction of a bf16 step, so after a
    layer about half of the elements sit one step apart; measured at values
    of about 1 (one step 2^-8 to 2^-6): max 0.0625, mean 5.4e-3 to 5.6e-3 in
    all three cases. Bounds: max <= 0.125, mean <= 1e-2, and the port's mean
    distance to the JAX f32 result at most 1.25 times the JAX bf16 kernel's.
    """
    trunk, _, win = _case(dim)
    tdt = getattr(torch, dtype)
    params = T.stack_trunk_params(trunk.blocks, tdt)
    with torch.inference_mode():
        got = T.fused_window_trunk(torch.from_numpy(win).to(tdt), params,
                                   mode)
    assert got.dtype == tdt and got.shape == win.shape
    got, want = got.float().numpy(), jax_trunks[dim, mode, dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        return
    err = np.abs(got - want)
    assert err.max() <= 0.125 and err.mean() <= 1e-2, (err.max(), err.mean())
    exact = jax_trunks[dim, mode, "float32"]
    ours, theirs = np.abs(got - exact).mean(), np.abs(want - exact).mean()
    assert ours <= 1.25 * theirs, (ours, theirs)


def test_v1_and_v2_differ_only_in_rounding():
    """The two modes are one function: equal at f32 to float error, apart in
    bf16 (the association moves roundings)."""
    trunk, _, win = _case(128)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        params = T.stack_trunk_params(trunk.blocks, dt)
        x = torch.from_numpy(win).to(dt)
        outs[dt] = [T.fused_window_trunk(x, params, m).float()
                    for m in ("v1", "v2")]
    torch.testing.assert_close(*outs[torch.float32], atol=1e-5, rtol=1e-5)
    assert not torch.equal(*outs[torch.bfloat16])
    with pytest.raises(ValueError, match="mode"):
        T.fused_window_trunk(torch.from_numpy(win), params, "v3")


def test_stack_trunk_params_packs_c128():
    """At C=128 a layer is 24 slabs of 128 rows x 64: per head group (two
    of 4 heads) k, v, q chunks and proj's rows, per hidden chunk (8) fc1's
    chunk and fc2's rows; vpack 13 x 128. No int8 packs at this width: the
    kernel's int8 mode is C=192's."""
    trunk, _, _ = _case(128)
    p = T.stack_trunk_params(trunk.blocks, torch.bfloat16, int8_rowwise=True)
    assert p["wpack"].shape == (2, 24, 128, 64)
    assert p["vpack"].shape == (2, 13 * 128)
    assert p["bias"].shape == (2, 8, 64, 64)
    w = p["wpack"]

    def tiles(m, o0):  # outputs o0..o0+63 of m (128, out) as (2, 64, 64)
        return m[:, o0:o0 + 64].reshape(2, 64, 64).transpose(1, 2)

    # Head group 1: v (columns 320..383), q (64..127), proj's rows 64..127.
    torch.testing.assert_close(w[1, 5].reshape(2, 64, 64),
                               tiles(p["qkvw"][1], 320))
    torch.testing.assert_close(w[0, 6].reshape(2, 64, 64),
                               tiles(p["qkvw"][0], 64))
    torch.testing.assert_close(w[0, 7], p["projw"][0, 64:128, :].T)
    # Hidden chunk 7: fc1 columns 448..511, fc2 rows 448..511.
    torch.testing.assert_close(w[1, 8 + 2 * 7].reshape(2, 64, 64),
                               tiles(p["fc1w"][1], 448))
    torch.testing.assert_close(w[0, 8 + 2 * 7 + 1],
                               p["fc2w"][0, 448:512, :].T)
    torch.testing.assert_close(p["vpack"][1, 1536:], p["fc2b"][1])
    assert "wpack_i8" not in p and p["fc2w_q"].dtype == torch.int8


@pytest.mark.parametrize("impl", ["fused", "fused2"])
def test_window_transformer_fused_routes_match_jax_f32(rng, impl):
    """WindowTransformer (dim 32, 2 heads, 2 blocks) on the fused routes at
    f32, 48x80 -> 72x120 (3x5 tokens, one padded window): atol=5e-5,
    rtol=1e-4, as test_torch_models.py holds the other routes."""
    config = dict(transformer_dim=32, num_window_blocks=2, num_heads=2,
                  pallas_serve=True, attn_impl=impl)
    x = rng.random((1, 48, 80, 3)).astype(np.float32)
    model = get_model("WindowTransformer", device="cpu", **config)
    tree = seeded_params(model, 3)
    params_from_jax(model, tree)
    got = model(torch.from_numpy(x), res_out=(72, 120)).numpy()
    assert model.trunk_params()["qkvw"].shape == (2, 32, 96)
    want = np.asarray(jax_get_model("WindowTransformer", **config).apply(
        {"params": tree}, jnp.asarray(x), res_out=(72, 120)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def window_fused2_jax():
    path, name, route, in_hw, res_out = WINDOW_FUSED2
    return jax_fixture(route, in_hw, res_out, name)


def test_window_fused2_fixture_is_fresh(window_fused2_jax):
    """The committed JAX output equals what the JAX model gives now."""
    assert os.path.getsize(WINDOW_FUSED2[0]) < 100_000
    _assert_fresh(WINDOW_FUSED2[0], window_fused2_jax)


def test_window_fused2_route_matches_jax(window_fused2_jax):
    """The full-width model (dim 128, 8 blocks, 8 heads) on the fused2 route
    in bf16 against the JAX model: the interior (4 pixels cropped) within max
    abs 3e-2 and mean abs 3e-3, the limits of the other routes'
    fixtures."""
    path, name, route, _, res_out = WINDOW_FUSED2
    model = get_model(name, device="cpu", dtype=torch.bfloat16, **route)
    params_from_jax(model,
                    seeded_params(model, int(window_fused2_jax["seed"])))
    got = model(torch.from_numpy(window_fused2_jax["x"]),
                res_out=res_out).float().numpy()
    assert got.shape == window_fused2_jax["y"].shape == (1, *res_out, 3)
    err = np.abs(got - window_fused2_jax["y"])[:, 4:-4, 4:-4]
    assert err.max() <= 3e-2 and err.mean() <= 3e-3, (err.max(), err.mean())


if __name__ == "__main__":
    path, name, route, in_hw, res_out = WINDOW_FUSED2
    np.savez_compressed(path, **jax_fixture(route, in_hw, res_out, name))
    print("wrote", path, os.path.getsize(path), "bytes")
