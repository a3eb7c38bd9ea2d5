"""The split branch-B tail of the port against the JAX package on the CPU:
``split_tail_kernels`` (models/upsampler.py) and the plain version of
``tail_finish_stream`` (kernels/stream.py) against the Pallas kernel in
interpret mode.

The Pallas kernel reads the TPU's deinterleave4 layout and writes macro-8
rows; inputs are converted at the boundary as tests/test_pallas_stream.py
does, and the macro-8 output is a plain reshape of NHWC. The comparison
covers the whole frame, border included: both sides zero the mid outside the
image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.models.upsampler import (
    split_tail_kernels as jax_split_tail_kernels,
)
from transformerupscaler_tpu.ops.pallas.stream import (
    deinterleave4,
    tail_finish_stream as jax_tail_finish_stream,
)
from transformerupscaler_torch.kernels import stream as S
from transformerupscaler_torch.models.upsampler import (
    Upsampler,
    split_tail_kernels,
)
from transformerupscaler_torch.weights import seeded_params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_split_tail_kernels_match_jax(rng, scale):
    """f32 composition on both sides: atol=1e-6, rtol=1e-5 (summation order
    inside the composition einsums)."""
    up = seeded_params(Upsampler(3), 5)
    tk = (rng.standard_normal((3, 3, 3, 3)) * 0.3).astype(np.float32)
    tb = (rng.standard_normal(3) * 0.1).astype(np.float32)
    pk = (rng.standard_normal((3, 3, 64, 3)) * 0.05).astype(np.float32)
    pb = (rng.standard_normal(3) * 0.1).astype(np.float32)
    want = jax_split_tail_kernels(
        {k: jnp.asarray(v) for k, v in up.items()}, scale, jnp.asarray(tk),
        jnp.asarray(tb), jnp.float32, pre_kernel=jnp.asarray(pk),
        pre_bias=jnp.asarray(pb))
    got = split_tail_kernels({k: _t(v) for k, v in up.items()}, scale, _t(tk),
                             _t(tb), torch.float32, pre_kernel=_t(pk),
                             pre_bias=_t(pb))
    cm = {2: 12, 3: 27, 4: 12}[scale]
    assert got[0][0].shape == (5, 5, 64, cm)
    assert got[1][0].shape == (3, 3, cm, 3 * scale * scale)
    for (gk, gb), (wk, wb) in zip(got, want):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-6,
                                   rtol=1e-5)


def test_split_tail_kernels_cast_mid_and_keep_finish_f32(rng):
    """k_mid and b_mid take the compute dtype; k_fin and b_fin stay f32."""
    up = {k: _t(v) for k, v in seeded_params(Upsampler(3), 5).items()}
    (km, bm), (kf, bf) = split_tail_kernels(
        up, 2, _t(rng.standard_normal((3, 3, 3, 3))), _t(np.ones(3)),
        torch.bfloat16, pre_kernel=_t(rng.standard_normal((3, 3, 64, 3))),
        pre_bias=_t(np.ones(3)))
    assert km.dtype == bm.dtype == torch.bfloat16
    assert kf.dtype == bf.dtype == torch.float32


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hi_lo_fin", ["off", "wf", "full"])
@pytest.mark.parametrize("kh,cm,co", [(5, 12, 12), (5, 12, 48), (3, 27, 27)])
def test_tail_finish_plain_matches_pallas(rng, kh, cm, co, hi_lo_fin,
                                          out_dtype):
    """bf16 features and mid weights, f32 finish weights, the whole frame.

    The two sides sum the mid conv in different orders, so a mid element
    near a rounding boundary can land one bf16 step (2^-8 of a mid value of
    order 1) apart, which the finish weights (std 0.1) carry into the
    output: atol 3e-3 on the f32 output, plus one bf16 output step
    (rtol 2^-7) on the bf16 output."""
    b, h, w, c = 1, 24, 32, 64
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    km = (rng.standard_normal((kh, kh, c, cm)) * 0.05).astype(np.float32)
    bm = (rng.standard_normal(cm) * 0.1).astype(np.float32)
    kf = (rng.standard_normal((3, 3, cm, co)) * 0.1).astype(np.float32)
    bf = (rng.standard_normal(co) * 0.1).astype(np.float32)
    xd = deinterleave4(jnp.asarray(x).astype(jnp.bfloat16)
                       .reshape(b, h, w // 2, 2 * c))
    want = np.asarray(jax_tail_finish_stream(
        xd, jnp.asarray(km), jnp.asarray(bm), jnp.asarray(kf),
        jnp.asarray(bf), out_dtype=jnp.dtype(out_dtype),
        hi_lo_fin=hi_lo_fin, interpret=True), np.float32).reshape(b, h, w, co)
    odt = getattr(torch, out_dtype)
    got = S.tail_finish_stream(_t(x).bfloat16(), _t(km), _t(bm), _t(kf),
                               _t(bf), out_dtype=odt, hi_lo_fin=hi_lo_fin)
    assert got.dtype == odt and got.shape == (b, h, w, co)
    np.testing.assert_allclose(
        got.float().numpy(), want, atol=3e-3,
        rtol=2.0 ** -7 if out_dtype == "bfloat16" else 1e-5)


def test_tail_finish_zeroes_the_mid_outside_the_image(rng):
    """With zero mid weights the mid is its bias inside the image and zero
    outside, so a border output sums fewer taps than an interior one."""
    x = torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16)
    out = S.tail_finish_stream(
        x, torch.zeros(5, 5, 64, 12), torch.ones(12),
        torch.ones(3, 3, 12, 12), torch.zeros(12), out_dtype=torch.float32)
    assert out[0, 4, 8, 0] == 9 * 12
    assert out[0, 0, 8, 0] == 6 * 12
    assert out[0, 0, 0, 0] == 4 * 12
    assert out[0, 7, 15, 0] == 4 * 12


def test_tail_finish_rejects_unknown_mode(rng):
    x = torch.zeros(1, 8, 16, 64)
    with pytest.raises(ValueError, match="hi_lo_fin"):
        S.tail_finish_stream(x, torch.zeros(5, 5, 64, 12), None,
                             torch.zeros(3, 3, 12, 12), None, hi_lo_fin="hi")
