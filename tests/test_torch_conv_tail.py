"""The fused conv + tail of the port (``kernels.stream.conv3x3_tail_stream``
and ``conv3x3_tail_emit_stream``, on the CPU their plain versions) and the
adapters of ``kernels/encoder.py`` against the JAX package's Pallas kernels
in interpret mode: ``conv3x3_tail_stream`` and ``conv3x3_tail_emit_stream``
(ops/pallas/stream.py:584, 662), ``fused_encoder`` and ``fused_decoder``
(ops/pallas/encoder.py:239, 279).

The stream kernels read the TPU's deinterleave4 layout of the width-2 packed
map and write macro-8 rows (a plain reshape of NHWC); the encoder kernels
read the packed map (a reshape of NHWC). The conversions are the test's.
The whole frame is compared, border included: both sides zero the conv's
output outside the image before the tail.

Tolerances. f32: rtol 1e-4, atol 2e-5 (tests/test_pallas_stream.py's, sums
in another order). bf16: the conv's output is rounded to bf16 on both sides
from f32 sums taken in other orders, so an element near a rounding boundary
can land one bf16 step apart (2^-8 of a value of order 1) and the tail
weights (std 0.1, up to 49 x 64 taps) carry that into a few outputs. Each
case is held to one bf16 step of the output (rtol 2^-7) plus
atol = 2^-8 x max |conv output| x max |tail weight|, one such flip, and the
share of elements off by more than one bf16 step to under 1%. Each JAX
result is computed once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops.pallas.encoder import (
    fused_decoder as jax_fused_decoder,
    fused_encoder as jax_fused_encoder,
)
from transformerupscaler_tpu.ops.pallas.stream import (
    conv3x3_tail_emit_stream as jax_emit,
    conv3x3_tail_stream as jax_tail,
    deinterleave4,
)
from transformerupscaler_torch.kernels import LAUNCHES
from transformerupscaler_torch.kernels import encoder as E
from transformerupscaler_torch.kernels import stream as S

B, H, W = 1, 16, 64
# (kernel, tail size, tail ReLU, dtype, tail output dtype): row 10 (the
# decoder's 7x7 without ReLU, a 3x3) and row 11 (the encoder's 5x5 with
# ReLU), each in f32 and bf16, and f32 output from bf16 input.
CASES = [("tail", 7, False, "float32", "float32"),
         ("tail", 3, False, "float32", "float32"),
         ("tail", 7, False, "bfloat16", "bfloat16"),
         ("emit", 5, True, "float32", "float32"),
         ("emit", 5, True, "bfloat16", "bfloat16"),
         ("emit", 5, True, "bfloat16", "float32")]
ENC_DTYPES = ("float32", "bfloat16")


def deint_to_nhwc(y) -> torch.Tensor:
    """(B, H, 4, G, 2 C) deinterleave4 -> (B, H, 8 G, C) NHWC."""
    y = torch.from_numpy(np.array(y, np.float32))
    b, h, _, g, c2 = y.shape
    return y.permute(0, 1, 3, 2, 4).reshape(b, h, 8 * g, c2 // 2)


def macro8_to_nhwc(y) -> torch.Tensor:
    """(B, H, W / 8, 8 co) -> (B, H, W, co): a reshape."""
    y = torch.from_numpy(np.array(y, np.float32))
    b, h, wb, n = y.shape
    return y.reshape(b, h, 8 * wb, n // 8)


def _inputs(kt, seed, shape=(B, H, W)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, 64)).astype(np.float32)
    kc = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    bc = rng.standard_normal(64).astype(np.float32)
    kt_ = (rng.standard_normal((kt, kt, 64, 12)) * 0.1).astype(np.float32)
    bt = rng.standard_normal(12).astype(np.float32)
    return x, kc, bc, kt_, bt


def _tol(dtype, x, kc, bc, kt):
    if dtype == "float32":
        return dict(rtol=1e-4, atol=2e-5)
    feat = S.conv3x3_plain(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(kc), torch.from_numpy(bc), True)
    flip = 2.0 ** -8 * feat.float().abs().max().item() * np.abs(kt).max()
    return dict(rtol=2.0 ** -7, atol=float(flip))


def _assert_close(got, want, tol, bf16_out):
    torch.testing.assert_close(got.float(), want, **tol)
    if bf16_out:
        step = (got.float() - want).abs() > 2.0 ** -7 * want.abs()
        assert step.float().mean().item() < 1e-2


@pytest.fixture(scope="module")
def jax_stream():
    """Case index -> (tail NHWC, conv output NHWC or None)."""
    out = {}
    for i, (which, kt, relu, dtn, odt) in enumerate(CASES):
        x, kc, bc, kt_, bt = _inputs(kt, i)
        dt = jnp.dtype(dtn)
        xd = deinterleave4(jnp.asarray(x).astype(dt)
                           .reshape(B, H, W // 2, 128))
        args = (xd, jnp.asarray(kc), jnp.asarray(bc), jnp.asarray(kt_),
                jnp.asarray(bt))
        kw = dict(tail_relu=relu, rows=8, out_dtype=jnp.dtype(odt),
                  interpret=True)
        if which == "emit":
            a, feat = jax_emit(*args, **kw)
            out[i] = (macro8_to_nhwc(a), deint_to_nhwc(feat))
        else:
            out[i] = (macro8_to_nhwc(jax_tail(*args, **kw)), None)
    return out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{w}-{k}x{k}-{'relu-' if r else ''}{d}-{o}"
                              for w, k, r, d, o in CASES])
def test_fused_conv_tail_plain_matches_pallas(jax_stream, case):
    which, kt, relu, dtn, odt = CASES[case]
    x, kc, bc, kt_, bt = _inputs(kt, case)
    dt, out_dtype = getattr(torch, dtn), getattr(torch, odt)
    args = (torch.from_numpy(x).to(dt), torch.from_numpy(kc),
            torch.from_numpy(bc), torch.from_numpy(kt_), torch.from_numpy(bt))
    emit = which == "emit"
    name = "conv3x3_tail_emit_stream" if emit else "conv3x3_tail_stream"
    before = LAUNCHES[name]
    if emit:
        got, feat = S.conv3x3_tail_emit_stream(*args, tail_relu=relu,
                                               out_dtype=out_dtype)
    else:
        got = S.conv3x3_tail_stream(*args, tail_relu=relu,
                                    out_dtype=out_dtype)
    assert LAUNCHES[name] == before  # the CPU ran the plain version
    assert got.dtype == out_dtype and got.shape == (B, H, W, 12)
    want, want_feat = jax_stream[case]
    tol = _tol(dtn, x, kc, bc, kt_)
    _assert_close(got, want, tol, odt == "bfloat16")
    if emit:
        assert feat.dtype == dt and feat.shape == (B, H, W, 64)
        # The conv output is one rounding of the same f32 sum.
        torch.testing.assert_close(
            feat.float(), want_feat,
            **(tol if dtn == "float32" else dict(rtol=2.0 ** -7, atol=1e-3)))


@pytest.fixture(scope="module")
def jax_encoder():
    """dtype -> (feat, a, b) in NHWC from fused_encoder / fused_decoder."""
    out = {}
    for dtn in ENC_DTYPES:
        x, k2, b2, ka, ba = _inputs(5, 11, (1, 24, 48))
        _, _, _, kc, bc = _inputs(7, 12)
        dt = jnp.dtype(dtn)
        xj = jnp.asarray(x).astype(dt)
        feat, a12 = jax_fused_encoder(xj, jnp.asarray(k2), jnp.asarray(b2),
                                      jnp.asarray(ka), jnp.asarray(ba),
                                      relu_a=True, interpret=True)
        b12 = jax_fused_decoder(xj, jnp.asarray(k2), jnp.asarray(b2),
                                jnp.asarray(kc), jnp.asarray(bc),
                                interpret=True)
        out[dtn] = (torch.from_numpy(np.array(feat, np.float32)),
                    macro8_to_nhwc(a12), macro8_to_nhwc(b12))
    return out


@pytest.mark.parametrize("dtype", ENC_DTYPES)
def test_fused_encoder_and_decoder_match_pallas(jax_encoder, dtype):
    """Rows 17 and 18: the adapters round both biases to the compute dtype
    (encoder.py:250-254, 290-294) and serve the fused kernel; held as the
    stream kernels above."""
    x, k2, b2, ka, ba = _inputs(5, 11, (1, 24, 48))
    _, _, _, kc, bc = _inputs(7, 12)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(dt)
    t = {k: torch.from_numpy(v) for k, v in
         dict(k2=k2, b2=b2, ka=ka, ba=ba, kc=kc, bc=bc).items()}
    feat, a = E.fused_encoder(xt, t["k2"], t["b2"], t["ka"], t["ba"])
    dec = E.fused_decoder(xt, t["k2"], t["b2"], t["kc"], t["bc"])
    want_feat, want_a, want_b = jax_encoder[dtype]
    assert feat.dtype == a.dtype == dec.dtype == dt
    assert a.shape == dec.shape == (1, 24, 48, 12)
    bf16 = dtype == "bfloat16"
    # The conv bias rounds to bf16 before the conv in the adapter: the
    # plain conv with that bias is the reference of the flip bound.
    b2r = torch.from_numpy(b2).to(dt).float().numpy()
    torch.testing.assert_close(
        feat.float(), want_feat,
        **(dict(rtol=2.0 ** -7, atol=1e-3) if bf16
           else dict(rtol=1e-4, atol=2e-5)))
    _assert_close(a, want_a, _tol(dtype, x, k2, b2r, ka), bf16)
    _assert_close(dec, want_b, _tol(dtype, x, k2, b2r, kc), bf16)
    plain = E.fused_encoder_plain(xt, t["k2"], t["b2"], t["ka"], t["ba"])
    assert torch.equal(plain[0], feat) and torch.equal(plain[1], a)
    assert torch.equal(E.fused_decoder_plain(xt, t["k2"], t["b2"], t["kc"],
                                             t["bc"]), dec)


def test_adapters_round_the_biases_to_the_compute_dtype():
    """A bias that is not a bf16 value reaches the kernel rounded."""
    x = torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16)
    bias = torch.full((12,), 1.0 + 2.0 ** -10)
    zero = torch.zeros(3, 3, 64, 64)
    _, a = E.fused_encoder(x, zero, None, torch.zeros(5, 5, 64, 12), bias)
    b = E.fused_decoder(x, zero, None, torch.zeros(7, 7, 64, 12), bias)
    assert a.float().unique().tolist() == [1.0]
    assert b.float().unique().tolist() == [1.0]
    direct = S.conv3x3_tail_stream(x, zero, None, torch.zeros(7, 7, 64, 12),
                                   bias, out_dtype=torch.float32)
    assert direct.unique().tolist() == [1.0 + 2.0 ** -10]


def test_conv_output_is_zero_outside_the_image_for_the_tail():
    """With a zero conv kernel the conv output is relu(bias) inside the
    image and zero outside, so a corner output of a 3x3 all-ones tail sums
    4 pixels' channels and an interior one 9."""
    x = torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16)
    out, feat = S.conv3x3_tail_emit_stream(
        x, torch.zeros(3, 3, 64, 64), torch.ones(64),
        torch.ones(3, 3, 64, 12), None, tail_relu=False,
        out_dtype=torch.float32)
    assert feat.float().unique().tolist() == [1.0]
    assert out[0, 4, 8, 0] == 9 * 64
    assert out[0, 0, 0, 0] == 4 * 64
    assert out[0, 7, 8, 0] == 6 * 64


def test_fused_conv_tail_covers_every_row():
    """A size no slab or tile divides: every output is written (the JAX
    rows fallback leaves h % rows rows, stream.py:609-610, 679-680)."""
    x, kc, bc, kt_, bt = _inputs(7, 3, (1, 20, 52))
    args = [torch.from_numpy(v) for v in (x, kc, bc, kt_, bt)]
    out = S.conv3x3_tail_stream(*args)
    feat = torch.relu(torch.nn.functional.conv2d(
        args[0].permute(0, 3, 1, 2), args[1].permute(3, 2, 0, 1), args[2],
        padding=1))
    want = torch.nn.functional.conv2d(feat, args[3].permute(3, 2, 0, 1),
                                      args[4], padding=3).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
