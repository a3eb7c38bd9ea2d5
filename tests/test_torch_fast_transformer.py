"""The port's whole serving slice against the JAX model on the CPU.

JAX: ``FastTransformer(compose_tails=True, pallas_serve=True,
split_tail=False)``, whose stream kernels run in Pallas interpret mode.
Port: ``transformerupscaler_torch`` FastTransformer on ``device="cpu"``,
where each kernel wrapper computes its plain version. Both get the same
weights, drawn from a numpy seed and carried by ``params_from_jax``, at a
small trunk (dim 32, 2 heads of 16, 2 blocks; the kernels' 64 feature
channels stay), on a 16x32 input at four geometries: x2 with the squash
(res_out 24x48), x2 where the identity squash is skipped (32x64), and
upscale_factor 3 and 4.

f32 (this file): atol=1e-4, rtol=1e-4 everywhere; measured max abs error
1.9e-7 / 5.5e-7 / 4.8e-7 / 5.4e-7 for the four geometries.
bf16 (test_torch_fast_transformer_bf16.py): the frameworks round bf16 at
different points (compare tests/test_models.py:213), so the interior (a
2*scale ring cropped) must agree to max abs <= 3e-2 and mean abs <= 3e-3;
measured max 2.9e-3 / 3.9e-3 / 3.9e-3 / 7.8e-3, mean 2.3e-4 / 3.0e-4 /
3.1e-4 / 2.9e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
GEOMETRIES = [dict(res_out=(24, 48)), dict(res_out=(32, 64)),
              dict(upscale_factor=3), dict(upscale_factor=4)]
GEOMETRY_IDS = ["x2-squash", "x2-identity", "x3", "x4"]


def run_both(jdt, tdt, call):
    """(jax output, port output) as f32 numpy for one geometry."""
    model = get_model("FastTransformer", device="cpu", dtype=tdt,
                      compose_tails=True, pallas_serve=True, split_tail=False,
                      **SMALL)
    tree = seeded_params(model, 3)
    params_from_jax(model, tree)
    jm = jax_get_model("FastTransformer", dtype=jdt, compose_tails=True,
                       pallas_serve=True, split_tail=False, **SMALL)
    x = np.random.default_rng(1).random((1, 16, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), **call),
                      np.float32)
    got = model(torch.from_numpy(x), **call).float().numpy()
    assert got.shape == want.shape
    return want, got


@pytest.mark.parametrize("call", GEOMETRIES, ids=GEOMETRY_IDS)
def test_slice_f32_matches_jax(call):
    want, got = run_both(jnp.float32, torch.float32, call)
    assert 0.2 < np.mean((want > 0) & (want < 1))  # not all clipped
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
