"""The port's fused window trunk on the CPU, where the wrapper computes its
plain version (transformerupscaler_torch/kernels/trunk2.py), against the JAX
``fused_window_trunk_v2`` in Pallas interpret mode, at the model's full
width: dim 192, 12 heads of 16, window 8. Weights are drawn from a numpy
seed and carried by ``params_from_jax``."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.models.common import (
    WindowBlock as JaxWindowBlock,
    run_window_trunk as jax_run_window_trunk,
)
from transformerupscaler_tpu.ops.pallas.trunk2 import fused_window_trunk_v2
from transformerupscaler_torch.kernels import trunk2 as T
from transformerupscaler_torch.models.common import WindowBlock, run_window_trunk
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DIM, HEADS, WS = 192, 12, 8


class Trunk(nn.Module):
    def __init__(self, layers, impl="fused2"):
        super().__init__()
        self.impl = impl
        self.blocks = nn.ModuleList(WindowBlock(DIM, WS, HEADS)
                                    for _ in range(layers))

    def forward(self, tokens):
        return run_window_trunk(tokens, self.blocks, WS, self.impl)


class JaxTrunk(fnn.Module):
    layers: int

    def setup(self):
        self.blocks = [JaxWindowBlock(DIM, WS, HEADS, 4.0, 0.1, impl="fused2")
                       for _ in range(self.layers)]

    def __call__(self, tokens):
        return jax_run_window_trunk(tokens, self.blocks, WS)


def _trunk(layers, seed):
    trunk = Trunk(layers)
    tree = seeded_params(trunk, seed)
    params_from_jax(trunk, tree)
    return trunk, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_trunk_plain_matches_pallas(rng, dtype):
    """Two layers on three windows (an odd count: the JAX kernel pads to a
    pair). f32: atol=5e-5, rtol=1e-4, which also covers the JAX body's
    rational erf (1.5e-7). bf16: both sides round at the same points, and
    each stage alone differs in under 1% of its elements (f32 sums in
    another order), but one flipped element shifts its token's whole next
    product by ~1e-3, a quarter of a bf16 step, so after a layer about half
    of the elements sit one step apart. Measured at values of a few units
    (one step is 2^-7 to 2^-5): max abs 0.0625, mean abs 5.4e-3; bounds
    max <= 0.125, mean <= 1e-2. And the port must be as close to the f32
    result as the JAX bf16 kernel is: its mean abs error against JAX at f32
    (measured 6.8e-3) at most 1.25 times the JAX bf16 kernel's (6.4e-3)."""
    trunk, tree = _trunk(2, 11)
    win = rng.standard_normal((3, WS * WS, DIM)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jax_trunk(dt):
        return np.asarray(fused_window_trunk_v2(
            jnp.asarray(win).astype(dt),
            [tree[f"blocks_{i}"] for i in range(2)], HEADS, WS,
            interpret=True), np.float32)

    want = jax_trunk(jdt)
    params = T.stack_trunk_params(trunk.blocks, tdt)
    with torch.inference_mode():
        got = T.fused_window_trunk(torch.from_numpy(win).to(tdt), params)
    assert got.dtype == tdt and got.shape == win.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    else:
        err = np.abs(got - want)
        assert err.max() <= 0.125 and err.mean() <= 1e-2, (err.max(),
                                                           err.mean())
        exact = jax_trunk(jnp.float32)
        ours, theirs = np.abs(got - exact).mean(), np.abs(want - exact).mean()
        assert ours <= 1.25 * theirs, (ours, theirs)


def test_stack_trunk_params_casts_and_packs(rng):
    """Every stacked parameter takes the compute dtype except the f32
    relative bias and its tables; the slabs of ``wpack`` are the transposed
    GEMM weights in the order the kernel consumes them: per head group of
    64 channels k, v, q chunks of 64 outputs (C/64 tiles [64 outputs][64
    inputs]) and proj's rows of those channels [C outputs][64 inputs], then
    per hidden chunk of 64 fc1's chunk and fc2's rows."""
    trunk, _ = _trunk(2, 3)
    p = T.stack_trunk_params(trunk.blocks, torch.bfloat16)
    assert p["bias"].dtype == p["tables"].dtype == torch.float32
    assert p["bias"].shape == (2, HEADS, 64, 64)
    assert all(v.dtype == torch.bfloat16 for k, v in p.items()
               if k not in ("bias", "tables", "heads"))
    # The relative-position tables the bf16 kernel reads, from which the
    # gathered bias comes: bias[h, 8 yi + xi, 8 yj + xj] =
    # tables[h, (yi - yj + 7) * 15 + xi - xj + 7].
    assert p["tables"].shape == (2, HEADS, 225)
    torch.testing.assert_close(p["bias"][1, :, 8 * 3 + 5, 8 * 6 + 0],
                               p["tables"][1, :, (3 - 6 + 7) * 15 + 5 + 7])
    assert p["wpack"].shape == (2, 36, 192, 64) and p["vpack"].shape == (2, 2496)
    w = p["wpack"]

    def tiles(m, o0):  # outputs o0..o0+63 of m (192, out) as (3, 64, 64)
        return m[:, o0:o0 + 64].reshape(3, 64, 64).transpose(1, 2)

    # Head group 1: k (columns 256..319), v (448..511), q (64..127), proj.
    torch.testing.assert_close(w[1, 4].reshape(3, 64, 64),
                               tiles(p["qkvw"][1], 256))
    torch.testing.assert_close(w[0, 5].reshape(3, 64, 64),
                               tiles(p["qkvw"][0], 448))
    torch.testing.assert_close(w[1, 6].reshape(3, 64, 64),
                               tiles(p["qkvw"][1], 64))
    torch.testing.assert_close(w[0, 7], p["projw"][0, 64:128, :].T)
    # Hidden chunk 11: fc1 columns 704..767, fc2 rows 704..767.
    torch.testing.assert_close(w[1, 12 + 2 * 11].reshape(3, 64, 64),
                               tiles(p["fc1w"][1], 704))
    torch.testing.assert_close(w[0, 12 + 2 * 11 + 1],
                               p["fc2w"][0, 704:768, :].T)
    torch.testing.assert_close(p["vpack"][1, 384:960], p["qkvb"][1])
    torch.testing.assert_close(p["vpack"][0, 2304:], p["fc2b"][0])
    small = [WindowBlock(32, WS, 2)]
    assert "wpack" not in T.stack_trunk_params(small, torch.float32)


def test_run_window_trunk_fused2_matches_jax(rng):
    """The whole fused2 route of ``run_window_trunk`` at f32 on a 10x12 token
    grid, which is not a window multiple: the zero padding goes through the
    blocks unmasked on both sides. atol=5e-5, rtol=1e-4."""
    trunk, tree = _trunk(2, 13)
    tokens = rng.standard_normal((1, 10, 12, DIM)).astype(np.float32)
    want = np.asarray(JaxTrunk(2).apply({"params": tree}, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = trunk(torch.from_numpy(tokens)).numpy()
    assert got.shape == tokens.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_run_window_trunk_rejects_unknown_impl(rng):
    trunk, _ = _trunk(1, 0)
    with pytest.raises(ValueError, match="impl"):
        run_window_trunk(torch.zeros(1, 8, 8, DIM), trunk.blocks, WS,
                         "fused3")
