"""The port's window trunk (transformerupscaler_torch/models/common.py)
against the JAX XLA trunk (``attn_impl="xla"``) on the CPU at f32, at the
model's full width: 6 blocks, dim 192, 12 heads, window 8, on a token grid
that is not a window multiple (so the zero pad and unpad run). Weights are
drawn once from a numpy seed and carried by ``params_from_jax``."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn as nn

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.models.common import (
    WindowBlock as JaxWindowBlock,
    run_window_trunk as jax_run_window_trunk,
)
from transformerupscaler_torch.models.common import WindowBlock, run_window_trunk
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DIM, HEADS, BLOCKS, WS = 192, 12, 6, 8


class JaxTrunk(fnn.Module):
    def setup(self):
        self.blocks = [JaxWindowBlock(DIM, WS, HEADS, 4.0, 0.1)
                       for _ in range(BLOCKS)]

    def __call__(self, tokens):
        return jax_run_window_trunk(tokens, self.blocks, WS)


class Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList(WindowBlock(DIM, WS, HEADS)
                                    for _ in range(BLOCKS))

    def forward(self, tokens):
        return run_window_trunk(tokens, self.blocks, WS)


def test_window_trunk_matches_jax_xla_trunk(rng):
    trunk = Trunk()
    tree = seeded_params(trunk, 11)
    params_from_jax(trunk, tree)
    tokens = rng.standard_normal((1, 10, 12, DIM)).astype(np.float32)
    want = np.asarray(JaxTrunk().apply({"params": tree}, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = trunk(torch.from_numpy(tokens)).numpy()
    assert got.shape == tokens.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
