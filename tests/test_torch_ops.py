"""The port's plain ops (transformerupscaler_torch/ops, models/upsampler)
against their JAX counterparts on the CPU, at f32, with tests/test_parity.py's
tolerance (atol=5e-5, rtol=1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerupscaler_tpu.models.upsampler import (
    composed_tail_kernel as jax_composed_tail_kernel,
)
from transformerupscaler_tpu.ops.conv import (
    compose_conv3x3_kernels as jax_compose,
)
from transformerupscaler_tpu.ops.pixel_shuffle import (
    commute_conv_through_shuffle as jax_commute,
    pixel_shuffle as jax_pixel_shuffle,
)
from transformerupscaler_tpu.ops.resize import (
    resize_matrix as jax_resize_matrix,
    resize_shuffled as jax_resize_shuffled,
)
from transformerupscaler_torch.models.upsampler import (
    STAGES,
    composed_tail_kernel,
    last_shuffle_factor,
)
from transformerupscaler_torch.ops.conv import compose_conv3x3_kernels
from transformerupscaler_torch.ops.pixel_shuffle import (
    commute_conv_through_shuffle,
    pixel_shuffle,
)
from transformerupscaler_torch.ops.resize import resize_matrix, resize_shuffled

TOL = dict(atol=5e-5, rtol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("r", [2, 3, 4])
def test_pixel_shuffle_matches_jax(rng, r):
    x = rng.standard_normal((2, 3, 5, 3 * r * r)).astype(np.float32)
    np.testing.assert_array_equal(pixel_shuffle(_t(x), r).numpy(),
                                  np.asarray(jax_pixel_shuffle(jnp.asarray(x), r)))


@pytest.mark.parametrize("r,k", [(2, 3), (3, 3), (4, 3), (2, 5)])
def test_commute_conv_through_shuffle_matches_jax(rng, r, k):
    kern = rng.standard_normal((k, k, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        commute_conv_through_shuffle(_t(kern), r).numpy(),
        np.asarray(jax_commute(jnp.asarray(kern), r)))


@pytest.mark.parametrize("biases", [(True, True), (True, False),
                                    (False, True), (False, False)])
def test_compose_conv3x3_kernels_matches_jax(rng, biases):
    k1 = rng.standard_normal((3, 3, 6, 8)).astype(np.float32)
    k2 = rng.standard_normal((5, 5, 8, 4)).astype(np.float32)
    b1 = rng.standard_normal(8).astype(np.float32) if biases[0] else None
    b2 = rng.standard_normal(4).astype(np.float32) if biases[1] else None
    kc, bc = compose_conv3x3_kernels(
        _t(k1), None if b1 is None else _t(b1), _t(k2),
        None if b2 is None else _t(b2))
    jk, jb = jax_compose(jnp.asarray(k1), None if b1 is None else jnp.asarray(b1),
                         jnp.asarray(k2), None if b2 is None else jnp.asarray(b2))
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), **TOL)
    if jb is None:
        assert bc is None
    else:
        np.testing.assert_allclose(bc.numpy(), np.asarray(jb), **TOL)


@pytest.mark.parametrize("with_pre", [False, True])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_composed_tail_kernel_matches_jax(rng, scale, with_pre):
    """Both branch tails of the model: A (n=64 channels, no tail bias, no
    pre conv) and B (n=3, tail bias, decoder_conv2 folded in as pre)."""
    n = 3 if with_pre else 64
    up = {}
    for i, (mult, _) in enumerate(STAGES[scale]):
        up[f"s{scale}_c{i}_kernel"] = (rng.standard_normal((3, 3, n, mult * n))
                                       / np.sqrt(9 * n)).astype(np.float32)
        up[f"s{scale}_c{i}_bias"] = rng.standard_normal(mult * n).astype(np.float32)
    tk = (rng.standard_normal((3, 3, n, 3)) / np.sqrt(9 * n)).astype(np.float32)
    tb = rng.standard_normal(3).astype(np.float32) if with_pre else None
    pk = (rng.standard_normal((3, 3, 64, 3)) * 0.05).astype(np.float32)
    pb = rng.standard_normal(3).astype(np.float32)
    pre = dict(pre_kernel=pk, pre_bias=pb) if with_pre else {}
    jk, jb = jax_composed_tail_kernel(
        {k: jnp.asarray(v) for k, v in up.items()}, scale, jnp.asarray(tk),
        None if tb is None else jnp.asarray(tb), jnp.float32,
        **{k: jnp.asarray(v) for k, v in pre.items()})
    kc, bc = composed_tail_kernel(
        {k: _t(v) for k, v in up.items()}, scale, _t(tk),
        None if tb is None else _t(tb), torch.float32,
        **{k: _t(v) for k, v in pre.items()})
    assert kc.shape == jk.shape
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(bc.numpy(), np.asarray(jb), **TOL)
    assert last_shuffle_factor(scale) == STAGES[scale][-1][1]


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("sizes", [(48, 36), (20, 52), (17, 17)])
def test_resize_matrix_matches_jax(method, antialias, sizes):
    np.testing.assert_array_equal(
        resize_matrix(*sizes, method, antialias),
        jax_resize_matrix(*sizes, method, antialias))


@pytest.mark.parametrize("r,out_hw", [(2, (24, 48)), (3, (40, 100)),
                                      (4, (64, 100))])
def test_resize_shuffled_matches_jax(rng, r, out_hw):
    z = rng.random((1, 16, 32, 3 * r * r)).astype(np.float32)
    want = np.asarray(jax_resize_shuffled(jnp.asarray(z), r, out_hw))
    got = resize_shuffled(_t(z), r, out_hw).numpy()
    assert got.shape == (1, *out_hw, 3)
    np.testing.assert_allclose(got, want, **TOL)
