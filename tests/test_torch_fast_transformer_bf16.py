"""The port's whole serving slice against the JAX model at bf16; see
test_torch_fast_transformer.py for the set-up, the tolerance and the
measured errors. A file of its own so the two dtypes run on separate
test workers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_fast_transformer import GEOMETRIES, GEOMETRY_IDS, run_both


@pytest.mark.parametrize("call", GEOMETRIES, ids=GEOMETRY_IDS)
def test_slice_bf16_matches_jax(call):
    want, got = run_both(jnp.bfloat16, torch.bfloat16, call)
    c = 2 * (call.get("upscale_factor") or 2)
    err = np.abs(got - want)[:, c:-c, c:-c]
    assert err.max() <= 3e-2, err.max()
    assert err.mean() <= 3e-3, err.mean()
