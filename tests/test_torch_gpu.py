"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the serving frame does not reach (batch 2, sizes that are not
tile multiples). chip_smoke.py covers the serving shapes.

Marked ``gpu``; every test skips without a CUDA device. This file imports no
JAX, so on a GPU host without JAX it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

bf16 outputs must agree within one bf16 rounding step (rtol 2^-7) plus
atol 1e-3 (f32 summation order); f32 outputs within rtol 1e-5, atol 1e-4.
The split tail's output sits behind the mid's bf16 rounding, where a
different summation order can flip a mid element by one bf16 step (up to
2^-7 of a mid value of order 1), which a finish weight (std 0.1) carries
into the output: atol 4e-3 for both output types. The trunk rounds to bf16
some twenty times a layer, and one flipped element shifts its token's whole
next product, so after a layer about half of the elements sit one step
apart: after two layers at values of a few units, max abs <= 0.125 and
mean abs <= 1e-2. The two attention cores use fast exponentials, so a
probability can round to the next bf16 value than in the plain version; a
share of 2^-20 / 2^-8 of them does, each moving the f32 context by at most
2^-8 p |v|, mostly far below atol; where p is near 1 that can exceed one
output step, so the global core's wider cases are held to chip_smoke.py's
rule (``_held_to_f64``). The two int8 convs sum their
products exactly and round their epilogue as the plain version does: bit
for bit. The 3x3 conv's int8 output quantizes an f32 sum taken in another
order: at most one int8 step on under 0.1% of elements.

conv1 rounds its f32 sum to bf16 before the bias: a sum near a rounding
boundary can land one bf16 step of the sum apart (2^-7 of it), which the
bias add can leave larger than a step of the output; atol is therefore
2^-7 x max |sum|, rtol one output step. The fused conv + tail rounds the
conv's output to bf16 in between, where an f32 sum in another order can
flip an element by one step (2^-7 of it), which a tail weight carries
into the output: atol adds 2^-7 x max |conv output| x max |tail weight| to
the tolerance of the output type; the emitted conv output is one rounding:
the bf16 tolerance.

The engine's CUDA graphs: every route chip_smoke.py serves, at full model
width with seeded weights on 64x128 frames, replayed from its graph and run
eagerly by the same engine: the outputs agree bit for bit and the launch
counters count the same per frame.
"""

import numpy as np
import pytest
import torch

from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.kernels import launch_counts, reset_launches
from transformerupscaler_torch.kernels import conv3x3 as C3
from transformerupscaler_torch.kernels import encoder as E
from transformerupscaler_torch.kernels import gmha as G
from transformerupscaler_torch.kernels import patch_kernels as P
from transformerupscaler_torch.kernels import stream as S
from transformerupscaler_torch.kernels import trunk2 as T
from transformerupscaler_torch.kernels import window_attn as A
from transformerupscaler_torch.models.common import (
    WindowBlock,
    trunk_int8_scales,
)
from transformerupscaler_torch.ops import quant as Q

pytestmark = pytest.mark.gpu
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
F32_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("shape", [(1, 24, 48), (2, 13, 37)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_kernel_matches_plain(gen, shape, relu):
    x = _rn(gen, *shape, 64).bfloat16()
    k, b = _rn(gen, 3, 3, 64, 64, std=0.05), _rn(gen, 64)
    _close(S.conv3x3_stream(x, k, b, relu), S.conv3x3_plain(x, k, b, relu),
           BF16_TOL)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("kh", [5, 7])
def test_tail_kernel_matches_plain(gen, kh, co, out_dtype):
    x = _rn(gen, 2, 13, 37, 64).bfloat16()
    k, b = _rn(gen, kh, kh, 64, co, std=0.02), _rn(gen, co)
    got = S.tail_conv_stream(x, k, b, True, out_dtype)
    assert got.dtype == out_dtype
    _close(got, S.tail_conv_plain(x, k, b, True, out_dtype),
           F32_TOL if out_dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hi_lo_fin", S.HI_LO_FIN)
@pytest.mark.parametrize("kh,cm,co", [(5, 12, 12), (3, 27, 27), (5, 12, 48)])
def test_tail_finish_kernel_matches_plain(gen, kh, cm, co, hi_lo_fin,
                                          out_dtype):
    x = _rn(gen, 2, 13, 37, 64).bfloat16()
    km, bm = _rn(gen, kh, kh, 64, cm, std=0.03), _rn(gen, cm, std=0.1)
    kf, bf = _rn(gen, 3, 3, cm, co, std=0.1), _rn(gen, co, std=0.1)
    got = S.tail_finish_stream(x, km, bm, kf, bf, out_dtype, hi_lo_fin)
    assert got.dtype == out_dtype and got.shape == (2, 13, 37, co)
    _close(got, S.tail_finish_plain(x, km, bm, kf, bf, out_dtype, hi_lo_fin),
           dict(rtol=1e-5 if out_dtype == torch.float32 else 2.0 ** -7,
                atol=4e-3))


def _trunk_blocks(gen, dim, layers):
    blocks = [WindowBlock(dim, 8, dim // 16).cuda() for _ in range(layers)]
    for blk in blocks:
        for name, p in blk.named_parameters():
            z = _rn(gen, *p.shape)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.1 * z)
            elif name.endswith("bias") or name.endswith("bias_table"):
                p.copy_(0.1 * z)
            else:
                p.copy_(z * p.shape[0] ** -0.5)
    return blocks


@pytest.mark.parametrize("n_win,layers", [(1, 1), (5, 2)])
def test_window_trunk_kernel_matches_plain(gen, n_win, layers):
    blocks = _trunk_blocks(gen, 192, layers)
    params = T.stack_trunk_params(blocks, torch.bfloat16)
    win = _rn(gen, n_win, 64, 192).bfloat16()
    got = T.fused_window_trunk(win, params)
    want = T.fused_window_trunk_plain(win, params)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert err.max() <= 0.125 and err.mean() <= 1e-2, (err.max(), err.mean())


TRUNK_MODES = [(128, "v2"), (128, "v1"), (192, "v1"), (192, "int8_rowwise"),
               (192, "int8_static")]
# Every mode also where the kernel's windows a block change (one a block up
# to the SM count, then two) and where a block's second window is past the
# end (121, 241), 192 / v2 among them.
TRUNK_CASES = [(d, m, n) for d, m in TRUNK_MODES for n in (1, 3, 61)] + [
    (d, m, n) for d, m in [(128, "v2"), (128, "v1"), (192, "v1"),
                           (192, "v2"), (192, "int8_rowwise"),
                           (192, "int8_static")] for n in (121, 240, 241)]


@pytest.mark.parametrize("dim,mode,n_win", TRUNK_CASES,
                         ids=[f"{d}-{m}-{n}" for d, m, n in TRUNK_CASES])
def test_window_trunk_modes_match_plain(gen, dim, mode, n_win):
    """Every width and mode the kernel takes, two layers (192 / v2 at one
    to 61 windows: the test above). bf16 modes: the bound above. int8: a GEMM input one bf16 step apart can
    round to the neighbouring int8 value, which moves its row's product by
    one quantization step and, through attention, the window's other tokens
    (tests/test_torch_int8_trunk.py, against JAX): max abs <= 0.25, mean
    abs <= 0.03; the static mode, with scales calibrated on the same
    windows, flips the same way."""
    blocks = _trunk_blocks(gen, dim, 2)
    win = _rn(gen, n_win, 64, dim).bfloat16()
    params = T.stack_trunk_params(blocks, torch.bfloat16,
                                  mode == "int8_rowwise")
    if mode == "int8_static":
        params = T.add_static_int8(params, trunk_int8_scales(blocks, win))
    S.reset_launches()
    got = T.fused_window_trunk(win, params, mode)
    assert T.MODE_LAUNCHES[mode] == T.LAUNCHES["fused_window_trunk"] == 1
    want = T.fused_window_trunk_plain(win, params, mode)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    bound = (0.25, 0.03) if mode.startswith("int8") else (0.125, 1e-2)
    assert err.max() <= bound[0] and err.mean() <= bound[1], (err.max(),
                                                              err.mean())


@pytest.mark.parametrize("nw,heads", [(1, 1), (7, 8), (3, 5), (2, 16),
                                      (0, 8), (61, 8), (133, 8), (960, 8)])
def test_window_attention_kernel_matches_plain(gen, nw, heads):
    """One head, WindowTransformer's eight, an odd count (the last block of
    two heads is half empty), the widest C = 256; no windows (no launch),
    one and two waves of the card and 16 720p frames' windows."""
    qkv = _rn(gen, nw, 64, 3 * 16 * heads).bfloat16()
    bias = _rn(gen, heads, 64, 64, std=0.5)
    _poison(nw, 64, 16 * heads)
    S.reset_launches()
    got = A.window_attention_core(qkv, bias, heads)
    assert S.LAUNCHES["window_attention_core"] == int(nw > 0)
    assert got.shape == (nw, 64, 16 * heads) and got.dtype == torch.bfloat16
    _close(got, A.window_attention_plain(qkv, bias, heads), BF16_TOL)


def test_window_attention_reads_qkv_written_just_before(gen):
    """The core launched right after the product that writes its qkv, on
    the same stream, into a buffer that held NaNs: a core that started
    before the product ended would read them. At 960 windows a probability
    that rounds to the neighbouring bf16 value (the fast exponential) can
    move an output by more than one step: held to ``_held_to_f64``'s rule,
    with the bias."""
    nw, heads, c = 960, 8, 128
    x = _rn(gen, nw * 64, c).bfloat16()
    w = _rn(gen, c, 3 * c, std=c ** -0.5).bfloat16()
    bias = _rn(gen, heads, 64, 64, std=0.5)
    qkv = torch.full((nw * 64, 3 * c), float("nan"), dtype=torch.bfloat16,
                     device="cuda")
    torch.cuda.synchronize()
    torch.matmul(x, w, out=qkv)
    qkv = qkv.view(nw, 64, 3 * c)
    got = A.window_attention_core(qkv, bias, heads)
    # 7.9 M outputs: held as global_mha's wide cases are (_held_to_f64).
    g = got.float()
    want = A.window_attention_plain(qkv, bias, heads).float()
    torch.cuda.synchronize()
    beyond = (g - want).abs() > BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
    assert beyond.float().mean().item() <= 1e-4
    qh, kh, vh = (t.reshape(nw, 64, heads, 16).transpose(1, 2).double()
                  for t in qkv.split(c, dim=-1))
    p = torch.softmax((qh * 0.25) @ kh.transpose(-1, -2) + bias.double(), -1)
    ref = (p @ vh).transpose(1, 2).reshape(nw, 64, c)
    e_kernel, e_plain = (g.double() - ref).abs(), (want.double() - ref).abs()
    assert torch.isfinite(g).all()
    assert e_kernel.max() <= 1.25 * e_plain.max()
    assert e_kernel.mean() <= 1.25 * e_plain.mean()


@pytest.mark.parametrize("b,n,heads", [(1, 64, 1), (2, 200, 8), (1, 1, 4),
                                       (1, 333, 16), (3, 65, 2)])
def test_global_mha_kernel_matches_plain(gen, b, n, heads):
    """Token counts that are no multiple of the 64-key tile (one key past a
    tile, one key in all), batches, and q, k, v as slices of a packed qkv."""
    c = 16 * heads
    qkv = _rn(gen, b, n, 3 * c, std=1.5).bfloat16()
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    got = G.global_mha(q, k, v, heads)
    assert got.shape == (b, n, c) and got.is_contiguous()
    _close(got, G.global_mha_plain(q, k, v, heads), BF16_TOL)
    _close(G.global_mha(q.contiguous(), k.contiguous(), v.contiguous(), heads),
           got, dict(rtol=0, atol=0))


def _held_to_f64(got, q, k, v, heads):
    """chip_smoke.py's rule for global_mha: one bf16 step of the plain
    version on all but 1e-4 of the elements (a probability can round to the
    neighbouring bf16 value, which moves its row's context by 2^-8 p |v|),
    and max and mean error against attention carried in f64 from the same
    bf16 q, k, v at most 1.25 times the plain version's."""
    b, n, c = q.shape
    g = got.float()
    w = G.global_mha_plain(q, k, v, heads).float()
    torch.cuda.synchronize()
    beyond = (g - w).abs() > BF16_TOL["atol"] + BF16_TOL["rtol"] * w.abs()
    assert beyond.float().mean().item() <= 1e-4
    qh, kh, vh = (t.reshape(b, n, heads, 16).transpose(1, 2).double()
                  for t in (q, k, v))
    p = torch.softmax((qh * 0.25) @ kh.transpose(-1, -2), -1)
    ref = (p @ vh).transpose(1, 2).reshape(b, n, c)
    e_kernel, e_plain = (g.double() - ref).abs(), (w.double() - ref).abs()
    assert torch.isfinite(g).all()
    assert e_kernel.max() <= 1.25 * e_plain.max()
    assert e_kernel.mean() <= 1.25 * e_plain.mean()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 255, 256, 257])
@pytest.mark.parametrize("heads", [1, 8, 16])
def test_global_mha_tile_edges_match_plain(gen, n, heads):
    """Batch 3 at token counts around the kernel's tiles (64 keys a tile, 64
    query rows a warpgroup, 128 a block) and one token, with 1, 8 and 16
    heads, under ``_held_to_f64``; packed q, k, v slices give the same bits
    as contiguous copies."""
    c = 16 * heads
    qkv = _rn(gen, 3, n, 3 * c, std=1.5).bfloat16()
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    S.reset_launches()
    got = G.global_mha(q, k, v, heads)
    assert S.LAUNCHES["global_mha"] == 1
    assert got.shape == (3, n, c) and got.is_contiguous()
    _held_to_f64(got, q, k, v, heads)
    _close(G.global_mha(q.contiguous(), k.contiguous(), v.contiguous(), heads),
           got, dict(rtol=0, atol=0))


def test_global_mha_blocks_take_several_units(gen):
    """(3, 1000, 256) with 16 heads: 3 x 16 x 8 = 384 units of 128 query
    rows, more than two blocks an SM hold, so blocks go on to a second unit
    (the ring and its phases carry over), under ``_held_to_f64``."""
    qkv = _rn(gen, 3, 1000, 3 * 256, std=1.5).bfloat16()
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    _held_to_f64(G.global_mha(q, k, v, 16), q, k, v, 16)


def test_global_mha_at_3600_tokens_held_to_f64(gen):
    """The serving shape, (1, 3600, 128) with 8 heads."""
    qkv = _rn(gen, 1, 3600, 3 * 128, std=1.5).bfloat16()
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    _held_to_f64(G.global_mha(q, k, v, 8), q, k, v, 8)


@pytest.mark.parametrize("b,ht,wt,d", [(2, 3, 5, 64), (1, 2, 4, 192)])
def test_embed_kernel_matches_plain(gen, b, ht, wt, d):
    f = _rn(gen, b, 8 * ht, 8 * wt, 64).bfloat16()
    k, bias = _rn(gen, 8, 8, 64, d, std=0.02), _rn(gen, d)
    _close(S.embed_stream(f, k, bias), S.embed_plain(f, k, bias), BF16_TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_unembed_kernel_matches_plain(gen, relu):
    tok = _rn(gen, 2, 3, 5, 48).bfloat16()
    f = _rn(gen, 2, 24, 40, 64).bfloat16()
    k, bias = _rn(gen, 48, 8, 8, 64, std=0.05), _rn(gen, 64)
    _close(S.unembed_combine_stream(tok, f, k, bias, relu),
           S.unembed_combine_plain(tok, f, k, bias, relu), BF16_TOL)


def _int8_case(gen, shape, co, kh):
    """An int8 map and int8 weights with per-output-channel scales (one
    all-zero output channel), as the int8 scopes fold them."""
    x = _rn(gen, *shape, 64).abs()
    s = Q.act_scale(x)
    xq, _ = Q.quantize_act_ch(x, s)
    k = _rn(gen, kh, kh, 64, co, std=0.05)
    k[..., 0] = 0.0
    kq, ks = Q.fold_conv_kernel(k, s)
    return xq, kq, ks, _rn(gen, co, std=0.1)


# Widths around the int8 3x3's 64-pixel tiles and the int8 tail's strips
# (124 outputs at k = 5, 122 at k = 7, 64 a warpgroup), heights around the
# 3x3's 4-row tiles and the tails' reach, up to 130 rows, where ranges break
# into segments inside strips; batch 2.
INT8_W = [1, 63, 64, 65, 122, 124, 125, 128, 250]
INT8_H = [1, 2, 3, 4, 5, 7, 33, 130]
INT8_SHAPES = ([(1, 24, 48), (2, 13, 37)] + [(2, 5, w) for w in INT8_W]
               + [(2, h, 130) for h in INT8_H])


def _int8_exact(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_int8_kernel_matches_plain_exactly(gen, shape, relu,
                                                   out_dtype):
    """The int32 sums are exact and the epilogue rounds as the plain
    version does: bit for bit, every pixel (the outputs NaN-poisoned)."""
    xq, kq, ks, b = _int8_case(gen, shape, 64, 3)
    _poison(*shape, 64, dtype=out_dtype)
    S.reset_launches()
    got = S.conv3x3_int8_stream(xq, kq, ks, b, relu, out_dtype)
    assert S.LAUNCHES["conv3x3_int8_stream"] == 1 and got.dtype == out_dtype
    _int8_exact(got, S.conv3x3_int8_plain(xq, kq, ks, b, relu, out_dtype))


# (shape, co, out dtype): every npad and output type at the first shape;
# the widths and heights at every npad.
TAIL_INT8_CASES = (
    [((2, 13, 37), co, dt) for co in (12, 27, 48)
     for dt in (torch.bfloat16, torch.float32)]
    + [(shape, co, torch.bfloat16) for shape in INT8_SHAPES[2:]
       for co in (12, 27, 48)])


@pytest.mark.parametrize("shape,co,out_dtype", TAIL_INT8_CASES)
@pytest.mark.parametrize("kh,relu", [(5, True), (7, False)])
def test_tail_int8_kernel_matches_plain_exactly(gen, kh, relu, shape, co,
                                                out_dtype):
    xq, kq, ks, b = _int8_case(gen, shape, co, kh)
    _poison(*shape, co, dtype=out_dtype)
    S.reset_launches()
    got = S.tail_conv_int8_stream(xq, kq, ks, b, relu, out_dtype)
    assert S.LAUNCHES["tail_conv_int8_stream"] == 1
    assert got.shape == (*shape, co) and got.dtype == out_dtype
    _int8_exact(got, S.tail_conv_int8_plain(xq, kq, ks, b, relu, out_dtype))


@pytest.mark.parametrize("kind", ["conv3x3", "tail5", "tail7"])
def test_int8_convs_at_720p_match_plain_exactly(gen, kind):
    """The serving shapes at x2 (the 3x3 with ReLU, the 5x5 tail with ReLU,
    the 7x7 without), outputs NaN-poisoned: bit for bit, and two calls give
    the same bits."""
    kh, co = {"conv3x3": (3, 64), "tail5": (5, 12), "tail7": (7, 12)}[kind]
    xq, kq, ks, b = _int8_case(gen, (1, 720, 1280), co, kh)
    wrap, plain = ((S.conv3x3_int8_stream, S.conv3x3_int8_plain) if kh == 3
                   else (S.tail_conv_int8_stream, S.tail_conv_int8_plain))
    relu = kh != 7
    _poison(1, 720, 1280, co)
    got = wrap(xq, kq, ks, b, relu)
    _poison(1, 720, 1280, co)
    again = wrap(xq, kq, ks, b, relu)
    _int8_exact(got, plain(xq, kq, ks, b, relu))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(1, 24, 48), (2, 13, 37)])
def test_conv3x3_out_scale_kernel_matches_plain(gen, shape):
    """The int8 epilogue quantizes the f32 sum, which runs in another order
    than the plain version's: at most one int8 step, on under 0.1% of
    elements (tests/test_pallas_stream.py:221-243)."""
    x = _rn(gen, *shape, 64).bfloat16()
    k, b = _rn(gen, 3, 3, 64, 64, std=0.05), _rn(gen, 64)
    s = _rn(gen, 64).abs() * 0.02 + 1e-3
    S.reset_launches()
    got = S.conv3x3_stream(x, k, b, True, out_scale=s)
    assert got.dtype == torch.int8
    assert S.OPTION_LAUNCHES["conv3x3_stream.int8_out"] == 1
    want = S.conv3x3_plain(x, k, b, True, out_scale=s)
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d != 0).float().mean() < 1e-3


@pytest.mark.parametrize("b,ht,wt,d", [(2, 3, 5, 64), (1, 2, 4, 192)])
def test_embed_in_scale_kernel_matches_plain(gen, b, ht, wt, d):
    x = _rn(gen, b, 8 * ht, 8 * wt, 64)
    fq, s = Q.quantize_act_ch(x)
    k, bias = _rn(gen, 8, 8, 64, d, std=0.02), _rn(gen, d)
    S.reset_launches()
    got = S.embed_stream(fq, k, bias, in_scale=s)
    assert S.OPTION_LAUNCHES["embed_stream.int8_in"] == 1
    _close(got, S.embed_plain(fq, k, bias, in_scale=s), BF16_TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_unembed_feat_scale_kernel_matches_plain(gen, relu):
    tok = _rn(gen, 2, 3, 5, 48).bfloat16()
    fq, s = Q.quantize_act_ch(_rn(gen, 2, 24, 40, 64))
    k, bias = _rn(gen, 48, 8, 8, 64, std=0.05), _rn(gen, 64)
    S.reset_launches()
    got = S.unembed_combine_stream(tok, fq, k, bias, relu, feat_scale=s)
    assert S.OPTION_LAUNCHES["unembed_combine_stream.int8_skip"] == 1
    _close(got, S.unembed_combine_plain(tok, fq, k, bias, relu,
                                        feat_scale=s), BF16_TOL)


# The patch kernels cut every token row into runs of 32 tokens, one TMA box
# each, four runs a block: widths short of, equal to and just past a box
# multiple, one token row, two images.
EDGE_WT = [1, 5, 64, 65, 160]
EDGE_HT = [1, 3]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("ht", EDGE_HT)
@pytest.mark.parametrize("wt", EDGE_WT)
def test_embed_tiling_edges_match_plain(gen, wt, ht, d, int8):
    x = _rn(gen, 2, 8 * ht, 8 * wt, 64)
    k = _rn(gen, 8, 8, 64, d, std=4096 ** -0.5).bfloat16()
    bias = _rn(gen, d, std=0.1)
    if int8:
        f, s = Q.quantize_act_ch(x)
    else:
        f, s = x.bfloat16(), None
    got = S.embed_stream(f, k, bias, in_scale=s)
    assert got.shape == (2, ht, wt, d)
    _close(got, S.embed_plain(f, k, bias, in_scale=s), BF16_TOL)


@pytest.mark.parametrize("option", ["bf16", "relu", "feat_scale",
                                    "round_steps"])
@pytest.mark.parametrize("d", [16, 48, 192])
@pytest.mark.parametrize("ht", EDGE_HT)
@pytest.mark.parametrize("wt", EDGE_WT)
def test_unembed_tiling_edges_match_plain(gen, wt, ht, d, option):
    """round_steps within one bf16 step plus 2^-7 max |product|, as
    test_fused_patch_unembed_add_kernel_matches_plain bounds it."""
    tok = _rn(gen, 2, ht, wt, d).bfloat16()
    x = _rn(gen, 2, 8 * ht, 8 * wt, 64)
    k = _rn(gen, d, 8, 8, 64, std=d ** -0.5).bfloat16()
    bias = _rn(gen, 64)
    tol = BF16_TOL
    if option == "round_steps":
        f = x.bfloat16()
        got = P.fused_patch_unembed_add(tok, f, k, bias)
        want = P.fused_patch_unembed_add_plain(tok, f, k, bias)
        y_max = (tok.float() @ k.float().reshape(d, -1)).abs().max()
        tol = dict(rtol=2.0 ** -7, atol=2.0 ** -7 * y_max.item())
    elif option == "feat_scale":
        f, s = Q.quantize_act_ch(x)
        got = S.unembed_combine_stream(tok, f, k, bias, feat_scale=s)
        want = S.unembed_combine_plain(tok, f, k, bias, feat_scale=s)
    else:
        relu, f = option == "relu", x.bfloat16()
        got = S.unembed_combine_stream(tok, f, k, bias, relu)
        want = S.unembed_combine_plain(tok, f, k, bias, relu)
    assert got.shape == (2, 8 * ht, 8 * wt, 64)
    _close(got, want, tol)


@pytest.mark.parametrize("kind,d", [("embed", 256), ("embed", 320),
                                    ("unembed", 272), ("unembed", 512)])
def test_patch_kernels_wide_d_match_plain(gen, kind, d):
    """The embed past 192 columns (a second column group, partly past D) and
    the unembed past 256 (one warpgroup, 64-token tiles)."""
    x = _rn(gen, 2, 24, 8 * 65, 64).bfloat16()
    if kind == "embed":
        k = _rn(gen, 8, 8, 64, d, std=4096 ** -0.5).bfloat16()
        bias = _rn(gen, d, std=0.1)
        got, want = S.embed_stream(x, k, bias), S.embed_plain(x, k, bias)
        assert got.shape == (2, 3, 65, d)
    else:
        tok = _rn(gen, 2, 3, 65, d).bfloat16()
        k = _rn(gen, d, 8, 8, 64, std=d ** -0.5).bfloat16()
        bias = _rn(gen, 64)
        got = S.unembed_combine_stream(tok, x, k, bias, True)
        want = S.unembed_combine_plain(tok, x, k, bias, True)
        assert got.shape == x.shape
    _close(got, want, BF16_TOL)


def test_wrappers_count_launches_and_reject_bad_input(gen):
    x = _rn(gen, 1, 8, 16, 64).bfloat16()
    k = _rn(gen, 3, 3, 64, 64)
    S.reset_launches()
    S.conv3x3_stream(x, k)
    assert S.LAUNCHES["conv3x3_stream"] == 1
    with pytest.raises(ValueError):
        S.tail_finish_stream(x, _rn(gen, 7, 7, 64, 12), None,
                             _rn(gen, 3, 3, 12, 12), None)
    blocks = [WindowBlock(64, 8, 4).cuda()]
    with pytest.raises(ValueError):
        T.fused_window_trunk(_rn(gen, 1, 64, 64).bfloat16(),
                             T.stack_trunk_params(blocks, torch.bfloat16))
    p128 = T.stack_trunk_params(_trunk_blocks(gen, 128, 1), torch.bfloat16,
                                True)
    with pytest.raises(ValueError):  # the int8 mode is compiled at C=192
        T.fused_window_trunk(_rn(gen, 1, 64, 128).bfloat16(), p128,
                             "int8_rowwise")
    with pytest.raises(ValueError):  # int8 weights not stacked
        T.fused_window_trunk(
            _rn(gen, 1, 64, 192).bfloat16(),
            T.stack_trunk_params(_trunk_blocks(gen, 192, 1), torch.bfloat16),
            "int8_rowwise")
    assert sum(S.LAUNCHES.values()) == 1
    with pytest.raises(ValueError):  # heads of 8 channels
        A.window_attention_core(_rn(gen, 1, 64, 96).bfloat16(),
                                _rn(gen, 4, 64, 64), 4)
    with pytest.raises(ValueError):  # 16 tokens a window
        A.window_attention_core(_rn(gen, 1, 16, 96).bfloat16(),
                                _rn(gen, 2, 16, 16), 2)
    q = _rn(gen, 1, 10, 32).bfloat16()
    with pytest.raises(ValueError):  # heads of 8 channels
        G.global_mha(q, q, q, 4)
    with pytest.raises(ValueError):  # k's strides differ from q's
        G.global_mha(q, _rn(gen, 1, 10, 64).bfloat16()[..., :32], q, 2)
    with pytest.raises(TypeError):
        G.global_mha(q.float(), q.float(), q.float(), 2)
    assert sum(S.LAUNCHES.values()) == 1
    with pytest.raises(TypeError):
        S.conv3x3_stream(x.float(), k)
    with pytest.raises(ValueError):
        S.conv3x3_stream(x.transpose(1, 2), k)
    with pytest.raises(ValueError):
        S.tail_conv_stream(x, _rn(gen, 3, 3, 64, 12))
    assert S.LAUNCHES["conv3x3_stream"] == 1


# conv1's halo comes by TMA where W % 8 == 0, else by cp.async (W odd: rows
# shifted by one element); tiles of 8 x 32 pixels, two persistent blocks an
# SM. The serving frame (3600 tiles); cp.async at even and odd W; batch 3 on
# either path; ragged last tile rows and columns on the persistent loop
# (330 tiles by cp.async, 736 by TMA, both above 2 x 132 blocks).
CONV1_SHAPES = [(1, 720, 1280), (2, 20, 52), (1, 13, 37), (3, 30, 64),
                (3, 21, 45), (1, 260, 300), (1, 364, 488)]


def _conv1_check(gen, shape, relu, bias=True, dtype=torch.float32):
    x = torch.rand(*shape, 3, generator=gen, device="cuda").bfloat16()
    k = _rn(gen, 3, 3, 3, 64, std=0.3).to(dtype)
    b = _rn(gen, 64, std=0.1).to(dtype) if bias else None
    _poison(*shape, 64)
    S.reset_launches()
    got = S.conv1_stream(x, k, b, relu)
    assert S.LAUNCHES["conv1_stream"] == 1
    sums = S.conv1_plain(x, k).float().abs().max().item()
    _close(got, S.conv1_plain(x, k, b, relu),
           dict(rtol=2.0 ** -7, atol=2.0 ** -7 * sums))


@pytest.mark.parametrize("shape", CONV1_SHAPES)
@pytest.mark.parametrize("relu", [False, True])
def test_conv1_kernel_matches_plain(gen, shape, relu):
    _conv1_check(gen, shape, relu)


@pytest.mark.parametrize("shape", [(2, 20, 52), (1, 13, 37), (1, 364, 488)])
def test_conv1_kernel_without_bias_matches_plain(gen, shape):
    _conv1_check(gen, shape, True, bias=False)


@pytest.mark.parametrize("shape", [(1, 13, 37), (3, 30, 64)])
def test_conv1_kernel_takes_bf16_weights(gen, shape):
    _conv1_check(gen, shape, True, dtype=torch.bfloat16)


def _conv_tail_case(gen, shape, kt, co):
    x = _rn(gen, *shape, 64).bfloat16()
    kc, bc = _rn(gen, 3, 3, 64, 64, std=1 / 24), _rn(gen, 64, std=0.1)
    ktl = _rn(gen, kt, kt, 64, co, std=(kt * kt * 64) ** -0.5)
    bt = _rn(gen, co, std=0.1)
    feat = S.conv3x3_plain(x, kc, bc, True).float().abs().max().item()
    return x, kc, bc, ktl, bt, 2.0 ** -7 * feat * ktl.abs().max().item()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kt,relu,emit", [(7, False, False), (5, True, True),
                                          (3, False, True), (3, True, False)])
@pytest.mark.parametrize("shape,co", [((2, 20, 52), 12), ((1, 33, 17), 48),
                                      ((1, 16, 16), 27)])
def test_conv_tail_kernel_matches_plain(gen, shape, co, kt, relu, emit,
                                        out_dtype):
    x, kc, bc, ktl, bt, flip = _conv_tail_case(gen, shape, kt, co)
    tol = dict(F32_TOL if out_dtype == torch.float32 else BF16_TOL)
    tol["atol"] += flip
    args = (x, kc, bc, ktl, bt, relu, out_dtype)
    if emit:
        got, feat = S.conv3x3_tail_emit_stream(*args)
        want, want_feat = S.conv3x3_tail_emit_plain(*args)
        _close(feat, want_feat, BF16_TOL)
    else:
        got = S.conv3x3_tail_stream(*args)
        want = S.conv3x3_tail_plain(*args)
    assert got.dtype == out_dtype and got.shape == (*shape, co)
    _close(got, want, tol)


@pytest.mark.parametrize("emit", [False, True])
def test_conv_tail_kernel_at_720p_matches_plain(gen, emit):
    """The serving shapes: the decoder's 7x7 without ReLU, the encoder's
    5x5 with ReLU and the conv output emitted."""
    kt = 5 if emit else 7
    x, kc, bc, ktl, bt, flip = _conv_tail_case(gen, (1, 720, 1280), kt, 12)
    tol = dict(BF16_TOL, atol=BF16_TOL["atol"] + flip)
    if emit:
        got, feat = S.conv3x3_tail_emit_stream(x, kc, bc, ktl, bt)
        want, want_feat = S.conv3x3_tail_emit_plain(x, kc, bc, ktl, bt)
        _close(feat, want_feat, BF16_TOL)
    else:
        got = S.conv3x3_tail_stream(x, kc, bc, ktl, bt)
        want = S.conv3x3_tail_plain(x, kc, bc, ktl, bt)
    _close(got, want, tol)


def test_fused_encoder_and_decoder_adapters_match_plain(gen):
    x, k2, b2, ka, ba, flip_a = _conv_tail_case(gen, (2, 20, 52), 5, 12)
    kc = _rn(gen, 7, 7, 64, 12, std=(49 * 64) ** -0.5)
    flip_b = flip_a / ka.abs().max().item() * kc.abs().max().item()
    S.reset_launches()
    feat, a = E.fused_encoder(x, k2, b2, ka, ba)
    dec = E.fused_decoder(x, k2, b2, kc, ba)
    assert S.LAUNCHES["conv3x3_tail_emit_stream"] == 1
    assert S.LAUNCHES["conv3x3_tail_stream"] == 1
    want_feat, want_a = E.fused_encoder_plain(x, k2, b2, ka, ba)
    _close(feat, want_feat, BF16_TOL)
    _close(a, want_a, dict(BF16_TOL, atol=BF16_TOL["atol"] + flip_a))
    _close(dec, E.fused_decoder_plain(x, k2, b2, kc, ba),
           dict(BF16_TOL, atol=BF16_TOL["atol"] + flip_b))


def test_new_wrappers_reject_bad_input(gen):
    x = _rn(gen, 1, 8, 16, 64).bfloat16()
    kc, kt = _rn(gen, 3, 3, 64, 64), _rn(gen, 5, 5, 64, 12)
    S.reset_launches()
    with pytest.raises(TypeError):
        S.conv3x3_tail_stream(x.float(), kc, None, kt)
    with pytest.raises(ValueError):  # a 9x9 tail
        S.conv3x3_tail_stream(x, kc, None, _rn(gen, 9, 9, 64, 12))
    with pytest.raises(ValueError):  # co above 48
        S.conv3x3_tail_emit_stream(x, kc, None, _rn(gen, 5, 5, 64, 64))
    with pytest.raises(TypeError):
        S.conv1_stream(_rn(gen, 1, 8, 16, 3), _rn(gen, 3, 3, 3, 64))
    with pytest.raises(ValueError):
        S.conv1_stream(_rn(gen, 1, 8, 16, 4).bfloat16(),
                       _rn(gen, 3, 3, 4, 64))
    assert sum(S.LAUNCHES.values()) == 0


CONV3X3_CASES = [(64, 64, True, True), (64, 256, False, True),
                 (256, 16, False, False), (8, 8, True, False),
                 (16, 8, False, False), (3, 5, True, True),
                 (40, 100, False, True)]


@pytest.mark.parametrize("shape", [(2, 13, 37), (3, 8, 16), (1, 6, 16)])
@pytest.mark.parametrize("c,o,relu,bias", CONV3X3_CASES)
def test_conv3x3_any_width_matches_plain(gen, shape, c, o, relu, bias):
    """The general conv at the JAX tests' widths and at widths that are not
    multiples of 8 or 16 (C = 3, 40; O = 5, 100), ragged tiles: one bf16
    step. Counted under ``ARCHIVED_LAUNCHES`` only."""
    x = _rn(gen, *shape, c).bfloat16()
    k = _rn(gen, 3, 3, c, o, std=(9 * c) ** -0.5)
    b = _rn(gen, o, std=0.3) if bias else None
    S.reset_launches()
    got = C3.conv3x3(x, k, b, relu, th=4)
    assert got.dtype == torch.bfloat16 and got.shape == (*shape, o)
    assert C3.ARCHIVED_LAUNCHES["conv3x3"] == 1
    assert sum(S.LAUNCHES.values()) == 0
    _close(got, C3.conv3x3_plain(x, k, b, relu), BF16_TOL)


# The JAX tests' widths (ops/pallas/conv3x3.py's tests).
CONV3X3_PINNED = [(64, 64), (64, 256), (256, 16), (8, 8), (16, 8)]


@pytest.mark.parametrize("shape", [(3, 7, 65), (1, 1, 1), (2, 5, 129),
                                   (1, 4, 64)])
@pytest.mark.parametrize("c,o", CONV3X3_PINNED)
def test_conv3x3_tile_edges_match_plain(gen, shape, c, o):
    """Around the kernel's tile of 4 rows x 64 pixels: batch 3 with an odd
    height and one pixel past a tile, a 1x1 image, two tiles and a pixel,
    one whole tile; bias and ReLU on, one bf16 step."""
    x = _rn(gen, *shape, c).bfloat16()
    k = _rn(gen, 3, 3, c, o, std=(9 * c) ** -0.5)
    b = _rn(gen, o, std=0.3)
    got = C3.conv3x3(x, k, b, True)
    assert got.shape == (*shape, o) and got.is_contiguous()
    _close(got, C3.conv3x3_plain(x, k, b, True), BF16_TOL)


@pytest.mark.parametrize("shift", range(9))
def test_wgmma_descriptor_row_shift(gen, shift):
    """The conv's A operand: a wgmma descriptor whose start sits ``shift``
    128-byte rows into a 128B-swizzled tile (base offset 0) reads rows shift
    .. shift + 63 of it. f32 sums of 64 bf16 products."""
    a = _rn(gen, 72, 64).bfloat16()
    b = _rn(gen, 64, 64).bfloat16()
    got = C3.desc_shift_probe(a, b, shift)
    _close(got, a[shift:shift + 64].float() @ b.float(), F32_TOL)


@pytest.mark.parametrize("shift", range(9))
def test_wgmma_i8_descriptor_row_shift(gen, shift):
    """The int8 convs' A operand: an int8 wgmma descriptor whose start sits
    ``shift`` 64-byte rows into a 64B-swizzled tile (odd shifts start inside
    a 128-byte address line) reads rows shift .. shift + 63 of it; int32
    sums of 64 int8 products, exact."""
    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    a, b = ri(72, 64), ri(64, 64)
    got = C3.desc_shift_probe_i8(a, b, shift)
    torch.cuda.synchronize()
    a, b = a.cpu().long(), b.cpu().long()
    assert torch.equal(got.cpu().long(), a[shift:shift + 64] @ b.t())


@pytest.mark.parametrize("b,ht,wt,d", [(2, 3, 5, 64), (1, 2, 4, 192)])
def test_fused_patch_embed_kernel_matches_plain(gen, b, ht, wt, d):
    f = _rn(gen, b, 8 * ht, 8 * wt, 64).bfloat16()
    k, bias = _rn(gen, 8, 8, 64, d, std=0.02), _rn(gen, d)
    S.reset_launches()
    got = P.fused_patch_embed(f, k, bias)
    assert P.ARCHIVED_LAUNCHES["fused_patch_embed"] == 1
    assert S.LAUNCHES["embed_stream"] == 0
    _close(got, P.fused_patch_embed_plain(f, k, bias), BF16_TOL)


@pytest.mark.parametrize("d", [48, 192])
def test_fused_patch_unembed_add_kernel_matches_plain(gen, d):
    """Three roundings after the product: a product summed in another
    order can round y one bf16 step apart, which the adds carry into the
    output: one bf16 step of the output plus 2^-7 max |y|."""
    tok = _rn(gen, 2, 3, 5, d).bfloat16()
    f = _rn(gen, 2, 24, 40, 64).bfloat16()
    k, bias = _rn(gen, d, 8, 8, 64, std=d ** -0.5), _rn(gen, 64)
    S.reset_launches()
    got = P.fused_patch_unembed_add(tok, f, k, bias)
    assert P.ARCHIVED_LAUNCHES["fused_patch_unembed_add"] == 1
    assert S.LAUNCHES["unembed_combine_stream"] == 0
    y_max = (tok.float() @ k.bfloat16().float().reshape(d, -1)).abs().max()
    _close(got, P.fused_patch_unembed_add_plain(tok, f, k, bias),
           dict(rtol=2.0 ** -7, atol=2.0 ** -7 * y_max.item()))


def test_archived_wrappers_reject_bad_input(gen):
    x = _rn(gen, 1, 8, 16, 64).bfloat16()
    S.reset_launches()
    with pytest.raises(TypeError):  # the card takes bf16
        C3.conv3x3(x.float(), _rn(gen, 3, 3, 64, 8))
    with pytest.raises(ValueError):  # a 5x5 kernel
        C3.conv3x3(x, _rn(gen, 5, 5, 64, 8))
    with pytest.raises(ValueError):  # D % 64
        P.fused_patch_embed(x, _rn(gen, 8, 8, 64, 96), None)
    with pytest.raises(ValueError):  # D % 16
        P.fused_patch_unembed_add(_rn(gen, 1, 1, 2, 40).bfloat16(), x,
                                  _rn(gen, 40, 8, 8, 64), None)
    with pytest.raises(ValueError):  # D > 512: no room for the token tile
        P.fused_patch_unembed_add(_rn(gen, 1, 1, 2, 528).bfloat16(), x,
                                  _rn(gen, 528, 8, 8, 64), None)
    p128 = T.add_static_int8(
        T.stack_trunk_params(_trunk_blocks(gen, 128, 1), torch.bfloat16),
        (torch.ones(1, 128),) * 3 + (torch.ones(1, 512),))
    with pytest.raises(ValueError):  # the int8 modes are compiled at C=192
        T.fused_window_trunk(_rn(gen, 1, 64, 128).bfloat16(), p128,
                             "int8_static")
    with pytest.raises(ValueError):  # static weights not stacked
        T.fused_window_trunk(
            _rn(gen, 1, 64, 192).bfloat16(),
            T.stack_trunk_params(_trunk_blocks(gen, 192, 1), torch.bfloat16),
            "int8_static")
    assert sum(launch_counts().values()) == 0


# conv3x3_stream on csrc/conv3x3.cu (tiles of 4 rows x 64 pixels): heights
# around the 4-row tile, widths around the 64-pixel tile, batch 3.
STREAM_H = [1, 3, 4, 5, 13]
STREAM_W = [1, 63, 64, 65, 130]


def _stream_conv_case(gen, shape):
    x = _rn(gen, *shape, 64).bfloat16()
    k, b = _rn(gen, 3, 3, 64, 64, std=576 ** -0.5), _rn(gen, 64, std=0.3)
    s = S.conv3x3_plain(x, k, b, True).float().abs().amax((0, 1, 2)) / 100
    return x, k, b, s + 1e-3


def _int8_close(got, want):
    """At most one int8 step, on under 0.1% of elements (an f32 sum in
    another order than the plain version's, near a half step); a tensor of
    under 1000 elements may have one such element."""
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == want.shape
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1
    assert (d != 0).sum().item() <= max(1, (d.numel() - 1) // 1000)


@pytest.mark.parametrize("w", STREAM_W)
@pytest.mark.parametrize("h", STREAM_H)
@pytest.mark.parametrize("int8", [False, True])
def test_conv3x3_stream_tile_edges_match_plain(gen, h, w, int8):
    x, k, b, s = _stream_conv_case(gen, (3, h, w))
    S.reset_launches()
    if int8:
        got = S.conv3x3_stream(x, k, b, True, out_scale=s)
        assert S.OPTION_LAUNCHES["conv3x3_stream.int8_out"] == 1
        _int8_close(got, S.conv3x3_plain(x, k, b, True, out_scale=s))
    else:
        got = S.conv3x3_stream(x, k, b, True)
        _close(got, S.conv3x3_plain(x, k, b, True), BF16_TOL)
    assert S.LAUNCHES["conv3x3_stream"] == 1


@pytest.mark.parametrize("hw", [(720, 1280), (360, 640)])
@pytest.mark.parametrize("int8", [False, True])
def test_conv3x3_stream_serving_shapes_match_plain(gen, hw, int8):
    """The serving shapes: bench's 720x1280, resid_packed's 360x640; two
    calls give the same bits."""
    x, k, b, s = _stream_conv_case(gen, (1, *hw))
    scale = s if int8 else None
    got = S.conv3x3_stream(x, k, b, True, out_scale=scale)
    again = S.conv3x3_stream(x, k, b, True, out_scale=scale)
    want = S.conv3x3_plain(x, k, b, True, out_scale=scale)
    if int8:
        _int8_close(got, want)
    else:
        _close(got, want, BF16_TOL)
    assert torch.equal(got, again)


def _poison(*shape, dtype=torch.bfloat16):
    """Leave a NaN-filled block of this size in the caching allocator, so
    that a wrapper's next torch.empty of it likely holds NaN wherever its
    kernel writes nothing."""
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


def _fused_check(gen, shape, kt, co, relu, emit, out_dtype):
    x, kc, bc, ktl, bt, flip = _conv_tail_case(gen, shape, kt, co)
    tol = dict(F32_TOL if out_dtype == torch.float32 else BF16_TOL)
    tol["atol"] += flip
    args = (x, kc, bc, ktl, bt, relu, out_dtype)
    _poison(*shape, 64)
    _poison(*shape, co, dtype=out_dtype)
    if emit:
        got, feat = S.conv3x3_tail_emit_stream(*args)
        want, want_feat = S.conv3x3_tail_emit_plain(*args)
        assert feat.shape == (*shape, 64)
        _close(feat, want_feat, BF16_TOL)  # every pixel, strip seams too
    else:
        got = S.conv3x3_tail_stream(*args)
        want = S.conv3x3_tail_plain(*args)
    assert got.dtype == out_dtype and got.shape == (*shape, co)
    _close(got, want, tol)


# Widths around one and two strips (58 outputs a strip at k = 7, 60 at 5,
# 62 at 3) and a wide one.
FUSED_W = list(range(57, 67)) + list(range(116, 123)) + [300]


@pytest.mark.parametrize("w", FUSED_W)
@pytest.mark.parametrize("kt,relu,emit", [(7, False, False), (5, True, True)])
def test_conv_tail_strip_widths_match_plain(gen, w, kt, relu, emit):
    _fused_check(gen, (2, 7, w), kt, 12, relu, emit, torch.bfloat16)


@pytest.mark.parametrize("h", [1, 2, 7, 33, 130])
@pytest.mark.parametrize("kt", [3, 5, 7])
def test_conv_tail_heights_match_plain(gen, h, kt):
    """Heights below and above the tail's reach; at 130 x 130 every block
    takes a few rows, so ranges break into segments inside strips."""
    _fused_check(gen, (1, h, 130), kt, 12, kt != 7, True, torch.bfloat16)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("kt", [3, 5, 7])
def test_conv_tail_output_groups_match_plain(gen, kt, co, emit, out_dtype):
    """npad 16, 32, 48: one, two and three 16-output groups a block."""
    _fused_check(gen, (2, 21, 70), kt, co, True, emit, out_dtype)


def test_wgmma_i8_probe(gen):
    """The trunk's int8 ``wgmma`` products alone, bit for bit against the
    int64 products of the same int8 operands: m64n64k32 from 64B-swizzled
    K-major tiles over K = 192 (the qkv and fc1 chunks), and m64n192k32
    with A built from an f32 accumulator's values by ``to_frags_i8`` and B
    a proj / fc2 slab in ``K_PERM`` order, which pins the fragment map and
    the 64B-swizzle descriptor."""
    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    a, b, a2, w2 = ri(64, 192), ri(64, 192), ri(64, 64), ri(64, 192)
    got1, got2 = T.wgmma_i8_probe(a, b, a2, w2)
    torch.cuda.synchronize()
    a, b, a2, w2 = (v.cpu().long() for v in (a, b, a2, w2))
    assert torch.equal(got1.cpu().long(), a @ b.t())
    assert torch.equal(got2.cpu().long(), a2 @ w2)


def _bf16_grid():
    """Every finite bf16 value, ascending."""
    d = (torch.arange(65536, dtype=torch.int32) << 16).view(torch.float32)
    return d[torch.isfinite(d)].unique().bfloat16()


def test_gelu_i8_sides_monotone(gen):
    """The rowwise int8 mode's first pass takes a row's largest |GELU
    output| from three pre-activations; that is exact when the card's
    bf16(gelu_i8(h)), over every finite bf16 h, never falls on h >= 0 and
    its magnitude never falls on h <= -0.75 nor rises on -0.75 < h < 0
    (csrc/window_trunk.cu ``GELU_TURN``)."""
    d = _bf16_grid()
    h = T.gelu_i8_probe(d.cuda()).float().cpu()
    d = d.float()
    assert torch.isfinite(h).all()
    assert (h[d >= 0].diff() >= 0).all()
    assert (h[d <= -0.75].abs().diff() >= 0).all()
    assert (h[(d > -0.75) & (d < 0)].abs().diff() <= 0).all()


@pytest.mark.parametrize("n", [48, 80, 112])
def test_wgmma_k_major_b_probe(gen, n):
    """``wgmma_ss_kb``: m64nNk16 with B K-major (128B swizzle), alone. f32
    sums of 64 bf16 products."""
    a = _rn(gen, 64, 64).bfloat16()
    b = _rn(gen, n, 64).bfloat16()
    _close(S.wgmma_kb_probe(a, b), a.float() @ b.float().t(), F32_TOL)


# The composed tail and the split tail on csrc/tail_strip.cu: strips of 124
# (k = 5) or 122 (k = 7) tail outputs and of 62 split-tail outputs.
TAIL_W = [1, 37, 61, 62, 63, 64, 65, 121, 122, 123, 124, 125, 126, 185, 186,
          187, 243, 244, 245, 249, 300]


def _tail_case(gen, shape, kh, co, relu, out_dtype):
    x = _rn(gen, *shape, 64).bfloat16()
    k, b = _rn(gen, kh, kh, 64, co, std=(kh * kh * 64) ** -0.5), _rn(gen, co)
    _poison(*shape, co, dtype=out_dtype)
    S.reset_launches()
    got = S.tail_conv_stream(x, k, b, relu, out_dtype)
    assert S.LAUNCHES["tail_conv_stream"] == 1
    assert got.dtype == out_dtype and got.shape == (*shape, co)
    _close(got, S.tail_conv_plain(x, k, b, relu, out_dtype),
           F32_TOL if out_dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("w", TAIL_W)
@pytest.mark.parametrize("kh,relu", [(5, True), (7, False)])
def test_tail_conv_strip_widths_match_plain(gen, w, kh, relu):
    """Widths under one strip, around one, two and three strips of 124 or
    122 outputs, where the second warpgroup's pixels fall off the image."""
    _tail_case(gen, (2, 5, w), kh, 12, relu, torch.bfloat16)


@pytest.mark.parametrize("h", [1, 2, 3, 7, 33, 130])
@pytest.mark.parametrize("kh", [5, 7])
def test_tail_conv_heights_match_plain(gen, h, kh):
    """Heights below the tail's reach and up to 130 x 250, where every
    persistent block takes a few strip-rows and ranges break into
    segments inside strips."""
    _tail_case(gen, (1, h, 250), kh, 12, True, torch.bfloat16)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("co", [12, 16, 27, 48])
@pytest.mark.parametrize("kh", [5, 7])
def test_tail_conv_output_groups_match_plain(gen, kh, co, relu, out_dtype):
    """npad 16, 32, 48: one, two and three passes of 16 outputs."""
    _tail_case(gen, (2, 19, 131), kh, co, relu, out_dtype)


def _finish_case(gen, shape, kh, cm, co, hi_lo_fin, out_dtype):
    """The split tail held to its plain version. A mid element that sums in
    another order can land one bf16 step (2^-7 of it) away, and a finish
    weight carries that into the output: atol adds one such flip."""
    x = _rn(gen, *shape, 64).bfloat16()
    km, bm = _rn(gen, kh, kh, 64, cm, std=(kh * kh * 64) ** -0.5), \
        _rn(gen, cm, std=0.1)
    kf, bf = _rn(gen, 3, 3, cm, co, std=(9 * cm) ** -0.5), \
        _rn(gen, co, std=0.1)
    mid = S.tail_conv_plain(x, km, bm, out_dtype=torch.float32)
    flip = 2.0 ** -7 * mid.abs().max().item() * kf.abs().max().item()
    tol = dict(F32_TOL if out_dtype == torch.float32 else BF16_TOL)
    tol["atol"] += flip
    _poison(*shape, co, dtype=out_dtype)
    S.reset_launches()
    got = S.tail_finish_stream(x, km, bm, kf, bf, out_dtype, hi_lo_fin)
    assert S.LAUNCHES["tail_finish_stream"] == 1
    assert got.dtype == out_dtype and got.shape == (*shape, co)
    _close(got, S.tail_finish_plain(x, km, bm, kf, bf, out_dtype, hi_lo_fin),
           tol)


@pytest.mark.parametrize("w", TAIL_W)
def test_tail_finish_strip_widths_match_plain(gen, w):
    """Widths under one strip and around one to four strips of 62."""
    _finish_case(gen, (2, 5, w), 5, 12, 12, "off", torch.bfloat16)


@pytest.mark.parametrize("h", [1, 2, 3, 4, 33, 130])
@pytest.mark.parametrize("kh", [3, 5])
def test_tail_finish_heights_match_plain(gen, h, kh):
    """Heights under one segment and up to 130 x 130, where ranges break
    into segments inside strips; the 3x3 mid centred in the 5x5 frame."""
    _finish_case(gen, (1, h, 130), kh, 12, 12, "off", torch.bfloat16)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hi_lo_fin", S.HI_LO_FIN)
@pytest.mark.parametrize("cm,co", [(12, 12), (16, 16), (27, 27), (32, 32),
                                   (12, 48), (16, 41)])
def test_tail_finish_modes_and_widths_match_plain(gen, cm, co, hi_lo_fin,
                                                 out_dtype):
    """Every (cmp, cop) pair, mode and output type, batch 2 over two
    strips."""
    _finish_case(gen, (2, 11, 100), 5, cm, co, hi_lo_fin, out_dtype)


@pytest.mark.parametrize("kind", ["tail5", "tail7", "finish"])
def test_tails_at_720p_match_plain(gen, kind):
    """The serving shapes at x2: bench's 5x5 with ReLU, xla_fold's 7x7, the
    split tail in mode "off"; two calls give the same bits."""
    if kind == "finish":
        _finish_case(gen, (1, 720, 1280), 5, 12, 12, "off", torch.bfloat16)
        return
    kh = 5 if kind == "tail5" else 7
    x = _rn(gen, 1, 720, 1280, 64).bfloat16()
    k, b = _rn(gen, kh, kh, 64, 12, std=(kh * kh * 64) ** -0.5), _rn(gen, 12)
    got = S.tail_conv_stream(x, k, b, kh == 5)
    again = S.tail_conv_stream(x, k, b, kh == 5)
    _close(got, S.tail_conv_plain(x, k, b, kh == 5), BF16_TOL)
    assert torch.equal(got, again)


# ------------------------------------------------------------ CUDA graphs
BENCH = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
RESID = dict(packed_serve=True, pallas_serve=True, attn_impl="fused2",
             token_hw=(4, 8))
# route -> (model, flags, environment, res_out, calibrated int8 scales)
ENGINE_ROUTES = {
    "xla_fold": ("FastTransformer", dict(BENCH, attn_impl="xla",
                                         split_tail=False), {}, None, False),
    "bench": ("FastTransformer", BENCH, {}, None, False),
    "bench_conv1": ("FastTransformer", dict(BENCH, conv1_stream=True), {},
                    None, False),
    "bench_fuse": ("FastTransformer", BENCH, {"TUX_FUSE_STREAM": "1"}, None,
                   False),
    "bench_int8_trunk": ("FastTransformer", dict(BENCH, int8_trunk=True), {},
                         None, False),
    "fast_fused": ("FastTransformer", dict(BENCH, attn_impl="fused"), {},
                   None, False),
    "fast_exact": ("FastTransformer", dict(dtype=torch.float32), {}, None,
                   False),
    "fast_exact_fused2": ("FastTransformer", dict(attn_impl="fused2"), {},
                          None, False),
    "window_pallas": ("WindowTransformer", dict(pallas_serve=True,
                                                attn_impl="pallas"), {},
                      None, False),
    "window_fused2": ("WindowTransformer", dict(pallas_serve=True,
                                                attn_impl="fused2"), {},
                      None, False),
    "window_fused": ("WindowTransformer", dict(pallas_serve=True,
                                               attn_impl="fused"), {},
                     None, False),
    "resid_packed": ("ResidualTransformer", RESID, {}, (128, 256), False),
    "resid_exact": ("ResidualTransformer", RESID, {}, None, False),
    "bicubic": ("BicubicInterpolation", {}, {}, None, False),
    **{f"int8_{scope}{suffix}": (
        "FastTransformer", dict(BENCH, int8_serve=True, int8_scope=scope), {},
        None, suffix == "") for scope, suffix in (
            ("tails", ""), ("tails", "_dyn"), ("residual", ""),
            ("full", ""))},
}


def _engines(tmp_path, route, monkeypatch):
    """(graphed, eager) engines of ``route`` on the same seeded weights
    (``root`` holds no checkpoint), calibrated alike where the route is,
    and the route's res_out."""
    model, flags, env, res_out, calibrate = ENGINE_ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    flags = {"dtype": torch.bfloat16, **flags}
    frame = _frames(1)[0]
    res_out = res_out or (96, 192)
    engines = tuple(UpscalerEngine(model, root=str(tmp_path),
                                   cuda_graphs=graphs, **flags)
                    for graphs in (True, False))
    if calibrate:
        scales = [e.calibrate_int8(frame, res_out=res_out) for e in engines]
        assert scales[0] == scales[1]
    return engines, res_out


def _frames(n, hw=(64, 128)):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("route", sorted(ENGINE_ROUTES))
def test_graphed_engine_equals_eager(gen, tmp_path, monkeypatch, route):
    (graphed, eager), res_out = _engines(tmp_path, route, monkeypatch)
    frames = _frames(3)
    graphed.upscale(frames[0], res_out=res_out)  # captures
    eager.upscale(frames[0], res_out=res_out)
    counts = []
    outs = []
    for engine in (graphed, eager):
        torch.cuda.synchronize()
        reset_launches()
        outs.append([engine.upscale(f, res_out=res_out) for f in frames])
        counts.append(launch_counts())
    assert counts[0] == counts[1]
    for got, want in zip(*outs):
        assert np.array_equal(got, want)
    assert len(graphed._cache) == 1 and not eager._cache
    dev = graphed.upscale(frames[0], res_out=res_out, device_out=True)
    key = next(iter(graphed._cache))
    assert dev.is_cuda and dev.data_ptr() != graphed._cache[key].out.data_ptr()
    assert np.array_equal(dev.cpu().numpy(), outs[1][0])


def test_graph_cache_per_geometry_and_calibration_clears_it(gen, tmp_path,
                                                            monkeypatch):
    (engine, _), res_out = _engines(tmp_path, "int8_tails", monkeypatch)
    big, small = _frames(1)[0], _frames(1, (32, 64))[0]
    for _ in range(2):
        engine.upscale(big, res_out=res_out)
    assert len(engine._cache) == 1
    engine.upscale(small, upscale_factor=2)
    engine.upscale(np.stack([big, big]), res_out=res_out)
    assert len(engine._cache) == 3
    engine.calibrate_int8(small, upscale_factor=2)
    assert not engine._cache
    assert engine.upscale(big, res_out=res_out).shape == (*res_out, 3)
    assert engine.warmup((32, 64), upscale_factor=2) > 0
    assert len(engine._cache) == 2
