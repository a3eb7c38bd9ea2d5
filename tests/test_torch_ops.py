"""The port's plain ops (transformerupscaler_torch/ops, models/upsampler)
against their JAX counterparts on the CPU, at f32, with tests/test_parity.py's
tolerance (atol=5e-5, rtol=1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.models.upsampler import (
    composed_tail_kernel as jax_composed_tail_kernel,
)
from transformerupscaler_tpu.ops.conv import (
    compose_conv3x3_kernels as jax_compose,
    conv2d as jax_conv2d,
)
from transformerupscaler_tpu.ops.patch import (
    patch_embed as jax_patch_embed,
    patch_unembed as jax_patch_unembed,
)
from transformerupscaler_tpu.ops.pixel_shuffle import (
    commute_conv_through_shuffle as jax_commute,
    pixel_shuffle as jax_pixel_shuffle,
)
from transformerupscaler_tpu.ops.resize import (
    interpolate_bicubic as jax_interpolate_bicubic,
    resize as jax_resize,
    resize_matrix as jax_resize_matrix,
    resize_shuffled as jax_resize_shuffled,
)
from transformerupscaler_torch.models.upsampler import (
    STAGES,
    composed_tail_kernel,
    last_shuffle_factor,
)
from transformerupscaler_torch.ops.conv import compose_conv3x3_kernels, conv2d
from transformerupscaler_torch.ops.patch import patch_embed, patch_unembed
from transformerupscaler_torch.ops.pixel_shuffle import (
    commute_conv_through_shuffle,
    pixel_shuffle,
)
from transformerupscaler_torch.ops.resize import (
    interpolate_bicubic,
    resize,
    resize_matrix,
    resize_shuffled,
)

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


@pytest.mark.parametrize("hw", [(16, 24), (15, 21)])
@pytest.mark.parametrize("stride,relu", [(1, True), (2, False)])
def test_conv2d_matches_jax(rng, hw, stride, relu):
    """Stride 2 is the models' downsample; odd extents round as PyTorch's
    ``padding=1`` does."""
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 8, 24)) * 0.1).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(b), stride=stride, relu=relu))
    got = conv2d(_t(x), _t(k), _t(b), stride=stride, relu=relu).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // stride),
                                       -(-hw[1] // stride), 24)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("method,antialias", [("bicubic", False),
                                              ("bilinear", True)])
@pytest.mark.parametrize("out_hw", [(24, 48), (27, 32), (16, 20)])
def test_resize_matches_jax(rng, method, antialias, out_hw):
    """Up, down and one unchanged extent (16 rows stay 16)."""
    x = rng.random((2, 16, 32, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw, method, antialias))
    got = resize(_t(x), out_hw, method, antialias).numpy()
    assert got.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(resize(_t(x[0]), out_hw, method,
                                      antialias).numpy(), want[0], **TOL)


def test_interpolate_bicubic_matches_jax_and_torch(rng):
    x = rng.random((1, 12, 20, 3)).astype(np.float32)
    got = interpolate_bicubic(_t(x), (18, 30)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_interpolate_bicubic(jnp.asarray(x), (18, 30))),
        **TOL)
    ref = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=(18, 30), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_interpolate_bicubic_bf16_matches_jax(rng):
    """bf16: the matrices are rounded to bf16 and the height pass is rounded
    before the width pass on both sides; summation order may flip single
    roundings of values in [0, 1.2]: max abs <= 2^-7."""
    x = rng.random((1, 12, 20, 3)).astype(np.float32)
    want = np.asarray(jax_interpolate_bicubic(
        jnp.asarray(x).astype(jnp.bfloat16), (24, 40)).astype(jnp.float32))
    got = interpolate_bicubic(_t(x).bfloat16(), (24, 40))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7


@pytest.mark.parametrize("c,d", [(64, 128), (8, 24)])
def test_patch_embed_and_unembed_match_jax(rng, c, d):
    x = rng.standard_normal((2, 16, 24, c)).astype(np.float32)
    ke = (rng.standard_normal((8, 8, c, d)) * 0.05).astype(np.float32)
    be = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(jax_patch_embed(jnp.asarray(x), jnp.asarray(ke),
                                      jnp.asarray(be)))
    tok = patch_embed(_t(x), _t(ke), _t(be))
    assert tok.shape == (2, 2, 3, d)
    np.testing.assert_allclose(tok.numpy(), want, **TOL)
    ku = (rng.standard_normal((d, 8, 8, c)) * 0.05).astype(np.float32)
    bu = rng.standard_normal(c).astype(np.float32)
    want = np.asarray(jax_patch_unembed(jnp.asarray(want), jnp.asarray(ku),
                                        jnp.asarray(bu)))
    got = patch_unembed(tok, _t(ku), _t(bu))
    assert got.shape == (2, 16, 24, c)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="patch size"):
        patch_embed(_t(x[:, :4]), _t(ke))
