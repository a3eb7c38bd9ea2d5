"""The int8 serving scopes' quantization, the plain versions of the two int8
conv kernels and the int8 options of the conv, embed and unembed kernels
(transformerupscaler_torch/ops/quant.py, ops/conv.py, kernels/stream.py)
against the JAX package on the CPU: its Pallas kernels in interpret mode
(as tests/test_pallas_stream.py runs them) and its XLA int8 convs.

- quantization bit for bit: ``quantize_conv_kernel``, the fold of an
  activation scale into a kernel, ``quantize_act_ch``, ``quantize_act`` and
  the dynamic per-channel scale of ``act_q`` / ``tail_scale``
  (models/fast_transformer.py:379-398, 495-507), with all-zero channels;
- the int8 3x3 conv against ``conv3x3_packed_int8_stream`` and
  ``conv2d_packed_int8``, the int8 tail at 5x5 with ReLU and at 7x7 without
  against ``tail_macro8_stream_int8`` and ``conv2d_tail_packed_int8``, and
  ``conv2d_int8``: f32 out, rtol = atol = 1e-4 as tests/test_pallas_stream.py
  holds the JAX kernels to each other (both sum the int8 products exactly;
  only the f32 epilogue may round differently);
- ``conv3x3_stream(out_scale=)``: at most one int8 step from
  ``conv3x3_deint_stream(out_scale=)`` on under 0.1% of elements (its f32
  sum runs in another order, and a value near a half step can round either
  way), the bound of tests/test_pallas_stream.py:221-243;
- ``embed_stream(in_scale=)`` and ``unembed_combine_stream(feat_scale=)``
  against the JAX kernels' options at f32, tests/test_parity.py's
  atol 5e-5, rtol 1e-4.

Layouts are converted at the boundary: NHWC <-> the width-2 packing
(reshape) <-> deinterleave4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops import quant as jq
from transformerupscaler_tpu.ops.conv import (
    conv2d_int8 as jax_conv2d_int8,
    conv2d_packed_int8,
    conv2d_tail_packed_int8,
)
from transformerupscaler_tpu.ops.pallas.stream import (
    conv3x3_deint_stream,
    conv3x3_packed_int8_stream,
    deinterleave4,
    embed_stream as jax_embed_stream,
    interleave4,
    tail_macro8_stream_int8,
    unembed_combine_stream as jax_unembed_combine_stream,
)
from transformerupscaler_torch.kernels import stream as S
from transformerupscaler_torch.ops import quant as Q
from transformerupscaler_torch.ops.conv import conv2d_int8

TOL = dict(atol=5e-5, rtol=1e-4)
INT8_TOL = dict(atol=1e-4, rtol=1e-4)


def _packed(x: np.ndarray):
    b, h, w, c = x.shape
    return jnp.asarray(x).reshape(b, h, w // 2, 2 * c)


def _nhwc(xp) -> np.ndarray:
    xp = np.asarray(xp)
    b, h, wp2, c2 = xp.shape
    return xp.reshape(b, h, 2 * wp2, c2 // 2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _scales(rng, n=64, mag=0.01):
    return (np.abs(rng.standard_normal(n)) * mag + 1e-3).astype(np.float32)


def _features(rng, h=16, w=32, dead=(5,)):
    """Non-negative NHWC f32 features, as after a ReLU, with dead channels."""
    x = np.abs(rng.standard_normal((1, h, w, 64))).astype(np.float32)
    x[..., list(dead)] = 0.0
    return x


def test_quantize_conv_kernel_matches_jax(rng):
    """Per output channel, bit for bit, including an all-zero channel
    (scale 1) and the fold of a per-input-channel scale."""
    k = (rng.standard_normal((7, 7, 64, 12)) * 0.1).astype(np.float32)
    k[..., 3] = 0.0
    q, s = Q.quantize_conv_kernel(_t(k))
    wq, ws = jq.quantize_conv_kernel(jnp.asarray(k))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert s[3] == 1.0
    scl = _scales(rng)
    q, s = Q.fold_conv_kernel(_t(k).bfloat16(), _t(scl))
    keff = (jnp.asarray(k).astype(jnp.bfloat16).astype(jnp.float32)
            * jnp.asarray(scl).reshape(1, 1, -1, 1))
    wq, ws = jq.quantize_conv_kernel(keff)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


def test_activation_quantize_matches_jax(rng):
    """The dynamic per-channel scale as ``act_q`` computes it on the packed
    layout (abs-max over pixels and batch, then over the two pixel
    parities, max(m, 1e-8) / 127), ``quantize_act_ch`` with it and with a
    given scale, and ``quantize_act``: bit for bit, on a bf16 map of mixed
    channel magnitudes with an all-zero channel."""
    x = (rng.standard_normal((2, 8, 32, 64))
         * rng.uniform(0.01, 20.0, 64)).astype(np.float32)
    x[..., 7] = 0.0
    xb = _t(x).bfloat16()
    t = _packed(x).astype(jnp.bfloat16)
    m = jnp.max(jnp.abs(t.astype(jnp.float32)), axis=(0, 1, 2))
    want_s = jnp.maximum(jnp.maximum(m[:64], m[64:]), 1e-8) / 127.0
    s = Q.act_scale(xb)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert s[7] == np.float32(1e-8) / np.float32(127.0)
    q, s2 = Q.quantize_act_ch(xb)
    wq, _ = jq.quantize_act_ch(t, jnp.tile(want_s, 2))
    np.testing.assert_array_equal(q.numpy(), _nhwc(wq))
    np.testing.assert_array_equal(s2.numpy(), s.numpy())
    scl = _scales(rng, mag=0.05)
    q, _ = Q.quantize_act_ch(xb, _t(scl))
    wq, _ = jq.quantize_act_ch(t, jnp.tile(jnp.asarray(scl), 2))
    np.testing.assert_array_equal(q.numpy(), _nhwc(wq))
    assert np.abs(q.numpy().astype(np.int32)).max() == 127
    q, s = Q.quantize_act(xb)
    wq, ws = jq.quantize_act(t)
    np.testing.assert_array_equal(q.numpy(), _nhwc(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


@pytest.fixture(scope="module")
def int8_case():
    r = np.random.default_rng(8)
    x = _features(r)
    scl = _scales(r)
    q, _ = jq.quantize_act_ch(_packed(x), jnp.tile(jnp.asarray(scl), 2))
    return _nhwc(q), scl


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_int8_plain_matches_jax(int8_case, relu):
    """The int8 3x3 conv: the plain version of the kernel (with the fold)
    and ``ops.conv.conv2d_int8`` against the Pallas kernel and the XLA
    packed int8 conv."""
    q, scl = int8_case
    r = np.random.default_rng(9)
    k = (r.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    qp = jnp.asarray(q.reshape(1, 16, 16, 128))
    pallas = _nhwc(conv3x3_packed_int8_stream(
        qp, k, scl, b, relu=relu, out_dtype=jnp.float32, rows=8,
        interpret=True))
    xla = _nhwc(conv2d_packed_int8(qp, jnp.asarray(k), scl, jnp.asarray(b),
                                   relu=relu, out_dtype=jnp.float32))
    kq, ks = Q.fold_conv_kernel(_t(k), _t(scl))
    got = S.conv3x3_int8_stream(_t(q), kq, ks, _t(b), relu, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (1, 16, 32, 64)
    np.testing.assert_allclose(got.numpy(), pallas, **INT8_TOL)
    np.testing.assert_allclose(got.numpy(), xla, **INT8_TOL)
    torch.testing.assert_close(
        conv2d_int8(_t(q), _t(k), _t(scl), _t(b), relu=relu,
                    out_dtype=torch.float32), got, atol=0, rtol=0)
    bf = S.conv3x3_int8_stream(_t(q), kq, ks, _t(b), relu)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, got.bfloat16(), atol=0, rtol=0)


@pytest.mark.parametrize("kh,relu", [(5, True), (7, False)])
def test_tail_int8_plain_matches_jax(int8_case, kh, relu):
    """The int8 tail, 64 -> 12, against the Pallas kernel and the XLA
    macro-block int8 conv (the JAX tails scope's two routes) and the
    direct NHWC ``conv2d_int8``."""
    q, scl = int8_case
    r = np.random.default_rng(kh)
    k = (r.standard_normal((kh, kh, 64, 12)) * 0.1).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    qp = jnp.asarray(q.reshape(1, 16, 16, 128))
    pallas = np.asarray(tail_macro8_stream_int8(
        deinterleave4(qp), k, scl, b, relu=relu, out_dtype=jnp.float32,
        rows=8, interpret=True)).reshape(1, 16, 32, 12)
    xla = np.asarray(conv2d_tail_packed_int8(
        qp, jnp.asarray(k), scl, jnp.asarray(b), relu=relu,
        out_dtype=jnp.float32, block=8)).reshape(1, 16, 32, 12)
    direct = np.asarray(jax_conv2d_int8(
        jnp.asarray(q), jnp.asarray(k), scl, jnp.asarray(b),
        padding=(kh - 1) // 2, relu=relu, out_dtype=jnp.float32))
    kq, ks = Q.fold_conv_kernel(_t(k), _t(scl))
    got = S.tail_conv_int8_stream(_t(q), kq, ks, _t(b), relu,
                                  torch.float32).numpy()
    for want in (pallas, xla, direct):
        np.testing.assert_allclose(got, want, **INT8_TOL)


def test_int8_product_is_exact():
    """The plain int8 conv sums int8 x int8 exactly whatever the order: at
    the extremes (every product 127 * 127 over 7 x 7 x 64 taps, past
    f32's 2^24) it equals the int64 sum rounded once to f32."""
    xq = torch.full((1, 8, 8, 64), 127, dtype=torch.int8)
    kq = torch.full((7, 7, 64, 3), -127, dtype=torch.int8)
    kq[..., 1] = 127
    kq[0, 0, 0, 2] = 1
    ks = torch.ones(3)
    got = S.tail_conv_int8_plain(xq, kq, ks, None, False, torch.float32)
    full = 49 * 64 * 127 * 127
    assert got[0, 4, 4, 1].item() == np.float32(full)
    assert got[0, 4, 4, 0].item() == np.float32(-full)
    assert got[0, 7, 7, 2].item() == np.float32(-(16 * 64 - 1) * 127 * 127
                                                + 127)


@pytest.fixture(scope="module")
def out_scale_case():
    r = np.random.default_rng(11)
    x = r.standard_normal((1, 16, 64, 64)).astype(np.float32)
    k = (r.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    scl = (np.abs(r.standard_normal(64)) * 0.02 + 1e-3).astype(np.float32)
    xd = deinterleave4(_packed(x))
    pallas = conv3x3_deint_stream(xd, k, b, relu=True, rows=8,
                                  out_scale=scl, interpret=True)
    return x, k, b, scl, _nhwc(interleave4(pallas))


def test_conv3x3_out_scale_matches_jax(out_scale_case):
    x, k, b, scl, want = out_scale_case
    got = S.conv3x3_stream(_t(x), _t(k), _t(b), True, out_scale=_t(scl))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3, (d.max(),
                                                     (d != 0).mean())
    # The epilogue multiplies by f32(1 / s); the plain version repeats it
    # on its own f32 result exactly.
    y = S.conv3x3_plain(_t(x), _t(k), _t(b), True)
    q = torch.clamp(torch.round(y * (1.0 / _t(scl))), -127, 127)
    torch.testing.assert_close(got, q.to(torch.int8), atol=0, rtol=0)


def test_embed_in_scale_matches_jax(rng):
    """The int8 embed: each tap dequantized to the compute dtype before
    its product; f32 here, as the JAX test runs it."""
    x = _features(rng)
    k = (rng.standard_normal((8, 8, 64, 48)) * 0.1).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    scl = _scales(rng)
    q, _ = jq.quantize_act_ch(_packed(x), jnp.tile(jnp.asarray(scl), 2))
    want = jax_embed_stream(deinterleave4(q), k, b, in_scale=scl,
                            out_dtype=jnp.float32, interpret=True)
    got = S.embed_stream(_t(_nhwc(q)), _t(k), _t(b), in_scale=_t(scl),
                         out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (1, 2, 4, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf = S.embed_stream(_t(_nhwc(q)), _t(k), _t(b), in_scale=_t(scl))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("relu", [False, True])
def test_unembed_feat_scale_matches_jax(rng, relu):
    x = _features(rng)
    tokens = rng.standard_normal((1, 2, 4, 48)).astype(np.float32)
    k = (rng.standard_normal((48, 8, 8, 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    scl = _scales(rng)
    q, _ = jq.quantize_act_ch(_packed(x), jnp.tile(jnp.asarray(scl), 2))
    want = jax_unembed_combine_stream(jnp.asarray(tokens), deinterleave4(q),
                                      k, b, relu=relu, feat_scale=scl,
                                      interpret=True)
    got = S.unembed_combine_stream(_t(tokens), _t(_nhwc(q)), _t(k), _t(b),
                                   relu, feat_scale=_t(scl))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _nhwc(interleave4(want)), **TOL)
