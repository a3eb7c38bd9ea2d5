"""The serving path's conv and patch kernels for Hopper, their wrappers and
their plain PyTorch versions (the window trunk is in ``kernels/trunk2.py``).

=========================  ====================  ================================
wrapper                    CUDA source           TPU kernel it replaces
=========================  ====================  ================================
``conv3x3_stream``         csrc/conv3x3.cu       ops/pallas/stream.py:425
                                                 ``conv3x3_deint_stream`` and
                                                 :82 ``conv3x3_packed_stream``
``tail_conv_stream``       csrc/tail_strip.cu    ops/pallas/stream.py:777
                                                 ``tail_macro8_stream``
``embed_stream``           csrc/patch_gemm.cu    ops/pallas/stream.py:325
                                                 ``embed_stream``
``unembed_combine_stream`` csrc/patch_gemm.cu    ops/pallas/stream.py:239
                                                 ``unembed_combine_stream``
``tail_finish_stream``     csrc/tail_strip.cu    ops/pallas/stream.py:1078
                                                 ``tail_finish_stream``
``conv3x3_int8_stream``    csrc/conv3x3.cu       ops/pallas/stream.py:147
                                                 ``conv3x3_packed_int8_stream``
``tail_conv_int8_stream``  csrc/tail_strip.cu    ops/pallas/stream.py:893
                                                 ``tail_macro8_stream_int8``
``conv1_stream``           csrc/conv1.cu         ops/pallas/stream.py:1269
                                                 ``conv1_dots_stream`` (call
                                                 :1308) and :1385
                                                 ``conv1_flat_stream``
``conv3x3_tail_stream``    csrc/conv_tail.cu     ops/pallas/stream.py:584
                                                 ``conv3x3_tail_stream``
``conv3x3_tail_emit_       csrc/conv_tail.cu     ops/pallas/stream.py:662
stream``                                         ``conv3x3_tail_emit_stream``
=========================  ====================  ================================

All tensors are NHWC. Each of the first four kernels takes bf16 activations
and weights, accumulates in f32, adds an f32 bias (and, for the unembed, the
skip tensor) in an f32 epilogue with an optional ReLU, and rounds once to the
output type. ``tail_finish_stream`` is two convs in one kernel and states its
own rounding points. Their int8 options, each as the TPU kernel has it:
``conv3x3_stream(out_scale=)`` quantizes its f32 result to int8 in the
epilogue, ``embed_stream(in_scale=)`` dequantizes an int8 input to bf16 tap
by tap, ``unembed_combine_stream(feat_scale=)`` adds an int8 skip
dequantized in f32. The two int8 convs take int8 activations and int8
weights quantized per output channel (``ops.quant.fold_conv_kernel``), sum
the products exactly in int32 and compute ``float(acc) * ks + bias`` in f32
without a fused multiply-add, so kernel and plain version agree bit for bit.
``conv1_stream`` keeps the TPU kernel's epilogue instead: the f32 sum is
rounded to bf16 first, then the bias is added in bf16 arithmetic. The two
fused conv + tail kernels run a 3x3 conv and a composed tail in one kernel,
with the conv's output rounded to bf16 and zero outside the image in
between, exactly as ``conv3x3_stream`` followed by ``tail_conv_stream``
would hand it over. The bounds at the 720x1280 serving shapes are stated in
each CUDA source.

``conv3x3_stream`` runs on the archived conv's kernel (``csrc/conv3x3.cu``)
with the weights as HWIO rows (``conv3x3_weight_rows``) and its bias
unrounded; the fused conv + tail, the composed tail and the split tail's
mid conv read their k x k weights as K-major slabs (``tail_slabs``), the
split tail's finish as hi / lo slabs (``finish_slabs``). The int8 convs are
the int8 forms of the same kernels: ``conv3x3_int8_stream`` of
``csrc/conv3x3.cu``'s with K-major slabs (``conv3x3_int8_slabs``),
``tail_conv_int8_stream`` of the composed tail's with ``tail_slabs`` in
int8.
``tests/test_torch_conv_layouts.py`` holds these layouts against the plain
versions on the CPU.

The patch kernels also serve two archived TPU kernels that no model reaches,
through ``embed_launch`` / ``unembed_launch``, which launch without counting:
``kernels.patch_kernels.fused_patch_embed`` (the embed with its bias rounded
to bf16) and ``fused_patch_unembed_add`` (the unembed's epilogue option
``round_steps``: bf16(acc), + bias in bf16, + skip in bf16). The archived
general 3x3 conv is ``kernels.conv3x3.conv3x3``, on its own kernel
(``csrc/conv3x3.cu``); each counts under ``ARCHIVED_LAUNCHES``.
``chip_smoke.py``'s ``archived`` line chains the three at 720p;
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_archived_kernels.py
-q`` holds them against the Pallas kernels.

A wrapper given CPU tensors computes its plain version: the CPU tests run
that. Given CUDA tensors it checks them, launches the kernel on the current
stream, adds one to ``LAUNCHES[<wrapper name>]`` (and, with an int8 option,
to ``OPTION_LAUNCHES``) and returns; it never falls back to the plain
version. The plain versions compute in f32 from the same rounded inputs,
with products as ``torch.matmul`` (which runs full f32 on the card unless a
caller enables TF32), so they hold the kernels' arithmetic up to summation
order; the int8 products they sum in float64, exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import (
    LAUNCHES,
    OPTION_LAUNCHES,
    check as _check,
    on_card as _on_card,
    raise_on as _raise_on,
    reset_launches,
    stream_of as _stream,
)
from transformerupscaler_torch.ops.conv import conv2d_int8_q

TAIL_NPAD = (16, 32, 48)  # supported padded output widths of the tail
HI_LO_FIN = ("off", "wf", "full")


def _bias32(bias, n: int, like: torch.Tensor) -> torch.Tensor:
    if bias is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    return bias.to(torch.float32).contiguous()


def _scale32(scale, name: str, n: int, like: torch.Tensor) -> torch.Tensor:
    """A per-channel f32 scale vector (n,) on like's device."""
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=like.device).contiguous()
    if tuple(s.shape) != (n,):
        raise ValueError(f"{name}: expected ({n},), got {tuple(s.shape)}")
    return s


def _quantize_out(y: torch.Tensor, out_scale) -> torch.Tensor:
    """The conv epilogue's quantize: clip(round(y * (1 / s)), -127, 127) to
    int8, with 1 / s computed in f32 (stream.py:474-475, 421)."""
    qs = 1.0 / _scale32(out_scale, "out_scale", y.shape[-1], y)
    return torch.clamp(torch.round(y * qs), -127, 127).to(torch.int8)


# ------------------------------------------------------------------ convs
def _conv_f32(x, kernel):
    """Zero-padded k x k conv of f32 tensors as one f32 matmul per tap."""
    k = kernel.shape[0]
    pad = (k - 1) // 2
    b, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    y = torch.zeros(b, h, w, kernel.shape[3], dtype=torch.float32,
                    device=x.device)
    for dy in range(k):
        for dx in range(k):
            y += xp[:, dy:dy + h, dx:dx + w, :] @ kernel[dy, dx]
    return y


def _conv_plain(x, kernel, bias, relu, out_dtype, out_scale=None):
    y = _conv_f32(x.float(), kernel.to(x.dtype).float())
    y = y + _bias32(bias, kernel.shape[3], x)
    if relu:
        y = torch.relu(y)
    if out_scale is not None:
        return _quantize_out(y, out_scale)
    return y.to(out_dtype)


def conv3x3_plain(x, kernel, bias=None, relu: bool = False,
                  out_scale=None):
    """Plain version of ``conv3x3_stream``."""
    return _conv_plain(x, kernel, bias, relu, x.dtype, out_scale)


def conv3x3_weight_rows(kernel: torch.Tensor) -> torch.Tensor:
    """A (3, 3, C, O) HWIO kernel as the (9 C, O) bf16 rows (dy, dx, c) of
    outputs that ``csrc/conv3x3.cu`` reads: HWIO as it is, no transpose."""
    k = kernel.to(torch.bfloat16).contiguous()
    return k.reshape(9 * k.shape[2], k.shape[3])


def conv3x3_stream(x: torch.Tensor, kernel: torch.Tensor, bias=None,
                   relu: bool = False, out_scale=None) -> torch.Tensor:
    """3x3 zero-padded conv, 64 -> 64 channels.

    x: (B, H, W, 64); kernel: (3, 3, 64, 64) HWIO, rounded to x's dtype;
    bias: (64,), kept f32. Returns (B, H, W, 64) in x's dtype.

    ``out_scale``: a (64,) per-channel static activation scale s; the
    output is then int8, q = clip(round(y * (1 / s)), -127, 127) from the
    f32 result y (after bias and ReLU), with 1 / s in f32 (the TPU kernel's
    option, stream.py:417-422, 474-475). Against a division by s it can
    differ by one step at exact ties; against the plain version, whose f32
    sum runs in another order, by one step near the half steps.
    """
    if not _on_card(x, kernel, bias):
        return conv3x3_plain(x, kernel, bias, relu, out_scale)
    b, h, w, _ = x.shape
    _check(x, "x", torch.bfloat16, (b, h, w, 64))
    if tuple(kernel.shape) != (3, 3, 64, 64):
        raise ValueError(f"kernel: expected (3, 3, 64, 64), got "
                         f"{tuple(kernel.shape)}")
    wt = conv3x3_weight_rows(kernel)
    bb = _bias32(bias, 64, x)  # f32, unrounded: the bias adds to the f32 sum
    _check(bb, "bias", torch.float32, (64,))
    qs = None
    if out_scale is not None:
        qs = 1.0 / _scale32(out_scale, "out_scale", 64, x)
        out = torch.empty(b, h, w, 64, dtype=torch.int8, device=x.device)
    else:
        out = torch.empty_like(x)
    err = _build.load("conv3x3").tux_conv3x3_any(
        x.data_ptr(), wt.data_ptr(), bb.data_ptr(),
        None if qs is None else qs.data_ptr(), out.data_ptr(), b, h, w, 64,
        64, 64, 64, int(relu), x.device.index, _stream(x))
    _raise_on(err, "conv3x3_stream")
    LAUNCHES["conv3x3_stream"] += 1
    if qs is not None:
        OPTION_LAUNCHES["conv3x3_stream.int8_out"] += 1
    return out


def tail_conv_plain(x, kernel, bias=None, relu: bool = False,
                    out_dtype=None):
    """Plain version of ``tail_conv_stream``."""
    return _conv_plain(x, kernel, bias, relu, out_dtype or x.dtype)


def tail_conv_stream(x: torch.Tensor, kernel: torch.Tensor, bias=None,
                     relu: bool = False, out_dtype=None) -> torch.Tensor:
    """Composed-tail conv: k x k zero-padded, 64 -> co channels.

    x: (B, H, W, 64); kernel: (k, k, 64, co) HWIO with k in {5, 7} and
    co <= 48, rounded to x's dtype; bias: (co,), kept f32 (the model passes
    the composed bias already rounded to the compute dtype). ``out_dtype``
    (default x's dtype) may be float32: only the final store changes.
    """
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, kernel, bias):
        return tail_conv_plain(x, kernel, bias, relu, out_dtype)
    b, h, w, _ = x.shape
    k, _, cin, co = kernel.shape
    _check(x, "x", torch.bfloat16, (b, h, w, 64))
    npad = next((n for n in TAIL_NPAD if co <= n), None)
    if k not in (5, 7) or kernel.shape[1] != k or cin != 64 or npad is None:
        raise ValueError(f"kernel: expected (k, k, 64, co), k in (5, 7), "
                         f"co <= {TAIL_NPAD[-1]}; got {tuple(kernel.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bfloat16 or float32, got {out_dtype}")
    wt = tail_slabs(kernel, npad)
    bb = _bias32(bias, co, x)
    _check(bb, "bias", torch.float32, (co,))
    out = torch.empty(b, h, w, co, dtype=out_dtype, device=x.device)
    err = _build.load("tail_strip").tux_tail_conv(
        x.data_ptr(), wt.data_ptr(), bb.data_ptr(), out.data_ptr(), b, h, w,
        k, co, npad, int(relu), int(out_dtype == torch.float32),
        x.device.index, _stream(x))
    _raise_on(err, "tail_conv_stream")
    LAUNCHES["tail_conv_stream"] += 1
    return out


# ------------------------------------------------------------------ conv1
def conv1_plain(x, kernel, bias=None, relu: bool = False):
    """Plain version of ``conv1_stream``: per tap (dy, dx, c) in that order
    one product added to an f32 sum with a single rounding, as a fused
    multiply-add rounds (taken in float64, where the product of two f32 is
    exact; the f64 sum of it and the f32 sum is then rounded to f32). That
    is the order and rounding of the reference's f32 dot over its K=108
    operand, whose extra taps are zeros (stream.py:1230-1245); for bf16
    inputs every product is exact and any f32 sum in this order agrees.
    Then JAX's epilogue order: round to x's dtype, add the bias rounded to
    it in that dtype, ReLU."""
    dt = x.dtype
    b, h, w, cin = x.shape
    k = kernel.to(dt).double()
    xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(b, h, w, kernel.shape[3], dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            for c in range(cin):
                tap = xp[:, dy:dy + h, dx:dx + w, c:c + 1]
                acc = (acc.double() + tap * k[dy, dx, c]).float()
    y = acc.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    return torch.relu(y) if relu else y


# The halo tile of csrc/conv1.cu: a block's tile is CONV1_TILE = (8, 32)
# output pixels; its input halo, 10 rows of 34 pixels x 3 channels, lies in
# shared memory as rows of CONV1_PITCH bf16 elements, pixel x0 - 1's first
# channel at element CONV1_LEAD of its row (the row starts at input column
# element 3 x0 - 8, where a TMA box may start).
CONV1_TILE, CONV1_PITCH, CONV1_LEAD = (8, 32), 112, 5


def conv1_taps() -> tuple[int, ...]:
    """The tap table the host hands ``csrc/conv1.cu``: for each column k =
    (dy * 3 + dx) * 3 + c of the 3x3x3 operand, K padded from 27 to 32, the
    element offset in the halo tile from the output pixel's own slot, -1
    where k >= 27 (a zero operand). Output pixel (row r, column p) of the
    tile reads k at element r * CONV1_PITCH + 3 p + taps[k] of the halo,
    that is input row y0 + r + dy - 1, column x0 + p + dx - 1, channel c."""
    taps = [dy * CONV1_PITCH + 3 * dx + c + CONV1_LEAD
            for dy in range(3) for dx in range(3) for c in range(3)]
    return tuple(taps + [-1] * (32 - len(taps)))


def conv1_stream(x: torch.Tensor, kernel: torch.Tensor, bias=None,
                 relu: bool = False) -> torch.Tensor:
    """conv1: 3x3 zero-padded conv, 3 -> 64 channels.

    x: (B, H, W, 3); kernel: (3, 3, 3, 64) HWIO, rounded to x's dtype;
    bias: (64,), rounded to x's dtype. Returns (B, H, W, 64) in x's dtype:
    the f32 sum rounded to that dtype first, then the bias added in it, then
    the ReLU (stream.py:1259-1263). The card takes bfloat16. The kernel
    reads the weights as HWIO rows and rounds f32 weights and bias to bf16
    itself, so a call launches nothing but the kernel when they are f32 or
    bf16 and contiguous.
    """
    if not _on_card(x, kernel, bias):
        return conv1_plain(x, kernel, bias, relu)
    b, h, w, _ = x.shape
    _check(x, "x", torch.bfloat16, (b, h, w, 3))
    if tuple(kernel.shape) != (3, 3, 3, 64):
        raise ValueError(f"kernel: expected (3, 3, 3, 64), got "
                         f"{tuple(kernel.shape)}")
    k, kb = _bf16_or_f32(kernel, "kernel")
    bb, bias_f32 = (None, 0) if bias is None else _bf16_or_f32(bias, "bias",
                                                               (64,))
    out = torch.empty(b, h, w, 64, dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.load("conv1").tux_conv1(
        x.data_ptr(), k.data_ptr(), None if bb is None else bb.data_ptr(),
        out.data_ptr(), ctypes.addressof(_conv1_taps_c()), b, h, w, int(relu),
        kb, bias_f32, x.device.index, _stream(x))
    _raise_on(err, "conv1_stream")
    LAUNCHES["conv1_stream"] += 1
    return out


@functools.cache
def _conv1_taps_c():
    """conv1_taps() as the C array the launch reads, kept alive here."""
    return (ctypes.c_int * 32)(*conv1_taps())


def _bf16_or_f32(t: torch.Tensor, name: str, shape=None):
    """``t`` as the kernel reads it, contiguous in bf16 or f32 (other types
    rounded to bf16 here), and 1 if f32."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        t = t.to(torch.bfloat16)
    t = t.contiguous()
    _check(t, name, t.dtype, shape or t.shape)
    return t, int(t.dtype == torch.float32)


# ---------------------------------------------------- fused conv + tail
def conv3x3_tail_emit_plain(x, conv_kernel, conv_bias, tail_kernel,
                            tail_bias=None, tail_relu: bool = True,
                            out_dtype=None):
    """Plain version of ``conv3x3_tail_emit_stream``: ``conv3x3_plain``
    with its ReLU, whose output is rounded to x's dtype and zero-padded by
    the tail, then ``tail_conv_plain``. Returns (tail output, conv
    output)."""
    feat = conv3x3_plain(x, conv_kernel, conv_bias, True)
    return (tail_conv_plain(feat, tail_kernel, tail_bias, tail_relu,
                            out_dtype or x.dtype), feat)


def conv3x3_tail_plain(x, conv_kernel, conv_bias, tail_kernel,
                       tail_bias=None, tail_relu: bool = False,
                       out_dtype=None):
    """Plain version of ``conv3x3_tail_stream``."""
    return conv3x3_tail_emit_plain(x, conv_kernel, conv_bias, tail_kernel,
                                   tail_bias, tail_relu, out_dtype)[0]


def tail_slabs(kernel: torch.Tensor, npad: int, frame: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """A (k, k, 64, co) HWIO tail kernel as the K-major slabs that
    ``csrc/conv_tail.cu`` and ``csrc/tail_strip.cu`` read: (npad / 16 x f x
    f x 16, 64) rows (group, dx, dy, output) of the 64 input channels in
    ``dtype`` (bf16; int8 for the int8 tail's folded kernel), outputs co ..
    npad - 1 zero. For each 16-output group and column shift dx, the f
    kernel rows (dy) stand side by side as one GEMM's N = 16 f columns.
    ``frame``: f, with the k x k kernel centred in a zero f x f frame (the
    split tail's 5x5 mid takes a 3x3 so); default k. On the card, a fill and
    one converting copy per 16-output group."""
    k, _, cin, co = kernel.shape
    f = frame or k
    p = (f - k) // 2
    out = torch.zeros(npad // 16, f, f, 16, cin, dtype=dtype,
                      device=kernel.device)
    for g in range(0, co, 16):
        n = min(16, co - g)
        out[g // 16, p:p + k, p:p + k, :n].copy_(
            kernel[..., g:g + n].permute(1, 0, 3, 2))
    return out.view(-1, cin)


def _conv_tail(x, conv_kernel, conv_bias, tail_kernel, tail_bias, tail_relu,
               out_dtype, emit: bool, name: str):
    """Launch the fused conv + tail kernel on CUDA tensors; returns (tail
    output, conv output or None)."""
    b, h, w, _ = x.shape
    _check(x, "x", torch.bfloat16, (b, h, w, 64))
    if tuple(conv_kernel.shape) != (3, 3, 64, 64):
        raise ValueError(f"conv_kernel: expected (3, 3, 64, 64), got "
                         f"{tuple(conv_kernel.shape)}")
    k, _, cin, co = tail_kernel.shape
    npad = next((n for n in TAIL_NPAD if co <= n), None)
    if k not in (3, 5, 7) or tail_kernel.shape[1] != k or cin != 64 \
            or npad is None:
        raise ValueError(f"tail_kernel: expected (k, k, 64, co), k in "
                         f"(3, 5, 7), co <= {TAIL_NPAD[-1]}; got "
                         f"{tuple(tail_kernel.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bfloat16 or float32, got {out_dtype}")
    wc = conv3x3_weight_rows(conv_kernel)
    wt = tail_slabs(tail_kernel, npad)
    bc, bt = _bias32(conv_bias, 64, x), _bias32(tail_bias, co, x)
    _check(bc, "conv_bias", torch.float32, (64,))
    _check(bt, "tail_bias", torch.float32, (co,))
    out = torch.empty(b, h, w, co, dtype=out_dtype, device=x.device)
    feat = torch.empty_like(x) if emit else None
    err = _build.load("conv_tail").tux_conv_tail(
        x.data_ptr(), wc.data_ptr(), bc.data_ptr(), wt.data_ptr(),
        bt.data_ptr(), out.data_ptr(), None if feat is None else
        feat.data_ptr(), b, h, w, k, co, npad, int(tail_relu),
        int(out_dtype == torch.float32), x.device.index, _stream(x))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, feat


def conv3x3_tail_stream(x: torch.Tensor, conv_kernel: torch.Tensor,
                        conv_bias, tail_kernel: torch.Tensor, tail_bias=None,
                        tail_relu: bool = False,
                        out_dtype=None) -> torch.Tensor:
    """A 3x3 64 -> 64 conv + ReLU fused with a k x k tail 64 -> co; the
    conv's output stays in the kernel. FastTransformer's decoder conv and
    folded branch-B tail (7x7 at x2). (The TPU kernels' ``conv_relu=False``,
    which no caller passes, is not carried.)

    x: (B, H, W, 64); conv_kernel: (3, 3, 64, 64) HWIO and tail_kernel:
    (k, k, 64, co) with k in {3, 5, 7} and co <= 48, both rounded to x's
    dtype; conv_bias (64,) and tail_bias (co,), kept f32. The conv's output
    (f32 sum, bias, ReLU) is rounded once to x's dtype and is zero
    outside the image, as the tail's zero pad (stream.py:516-521); the tail
    sums in f32, adds its bias, applies the optional ReLU and rounds once to
    ``out_dtype`` (default x's dtype; may be float32).
    """
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, conv_kernel, conv_bias, tail_kernel, tail_bias):
        return conv3x3_tail_plain(x, conv_kernel, conv_bias, tail_kernel,
                                  tail_bias, tail_relu, out_dtype)
    return _conv_tail(x, conv_kernel, conv_bias, tail_kernel, tail_bias,
                      tail_relu, out_dtype, False, "conv3x3_tail_stream")[0]


def conv3x3_tail_emit_stream(x: torch.Tensor, conv_kernel: torch.Tensor,
                             conv_bias, tail_kernel: torch.Tensor,
                             tail_bias=None, tail_relu: bool = True,
                             out_dtype=None):
    """``conv3x3_tail_stream`` that also returns the conv's output: the
    encoder's conv2 and branch-A tail (5x5 + ReLU at x2), whose conv output
    feeds the embed and the unembed. Returns (tail output, conv output
    (B, H, W, 64) in x's dtype); ``out_dtype`` applies to the tail output
    only."""
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, conv_kernel, conv_bias, tail_kernel, tail_bias):
        return conv3x3_tail_emit_plain(x, conv_kernel, conv_bias,
                                       tail_kernel, tail_bias, tail_relu,
                                       out_dtype)
    return _conv_tail(x, conv_kernel, conv_bias, tail_kernel, tail_bias,
                      tail_relu, out_dtype, True, "conv3x3_tail_emit_stream")


def wgmma_kb_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tail GEMM's ``wgmma`` shape alone (``sm90.cuh`` ``wgmma_ss_kb``):
    a (64, 64) and b (n, 64) bf16 on the card, n in {48, 80, 112}; returns
    a @ b.T in f32, computed by one warpgroup from 128B-swizzled K-major
    tiles of both."""
    n = b.shape[0]
    _check(a, "a", torch.bfloat16, (64, 64))
    _check(b, "b", torch.bfloat16, (n, 64))
    d = torch.empty(64, n, dtype=torch.float32, device=a.device)
    err = _build.load("conv_tail").tux_wgmma_kb_probe(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), n, a.device.index,
        _stream(a))
    _raise_on(err, "wgmma_kb_probe")
    return d


# ------------------------------------------------------------- int8 convs
def conv3x3_int8_slabs(kq: torch.Tensor) -> torch.Tensor:
    """A (3, 3, 64, 64) HWIO int8 kernel as the K-major slabs that
    ``csrc/conv3x3.cu``'s int8 form reads (int8 ``wgmma`` takes B K-major
    only): (9 x 64, 64) rows (dy, dx, output) of the 64 input channels. One
    copy."""
    return kq.permute(0, 1, 3, 2).contiguous().view(9 * kq.shape[3],
                                                    kq.shape[2])


def conv3x3_int8_plain(xq, kq, ks, bias=None, relu: bool = False,
                       out_dtype=torch.bfloat16):
    """Plain version of ``conv3x3_int8_stream``."""
    return conv2d_int8_q(xq, kq, ks, bias, 1, relu, out_dtype)


def conv3x3_int8_stream(xq: torch.Tensor, kq: torch.Tensor, ks, bias=None,
                        relu: bool = False,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """3x3 zero-padded int8 conv, 64 -> 64 channels.

    xq: (B, H, W, 64) int8, quantized per input channel; kq: (3, 3, 64, 64)
    int8 HWIO with that scale folded in, and ks: (64,) its f32 weight
    scales (``ops.quant.fold_conv_kernel``); bias: (64,), kept f32.
    out = act(float(sum xq * kq) * ks + bias) in f32, rounded once to
    ``out_dtype`` (bfloat16 or float32).
    """
    if not _on_card(xq, kq, ks, bias):
        return conv3x3_int8_plain(xq, kq, ks, bias, relu, out_dtype)
    b, h, w, _ = xq.shape
    _check(xq, "xq", torch.int8, (b, h, w, 64))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bfloat16 or float32, got {out_dtype}")
    _check(kq.contiguous(), "kq", torch.int8, (3, 3, 64, 64))
    wt = conv3x3_int8_slabs(kq)
    sc = _scale32(ks, "ks", 64, xq)
    bb = _bias32(bias, 64, xq)
    _check(bb, "bias", torch.float32, (64,))
    out = torch.empty(b, h, w, 64, dtype=out_dtype, device=xq.device)
    err = _build.load("conv3x3").tux_conv3x3_int8(
        xq.data_ptr(), wt.data_ptr(), sc.data_ptr(), bb.data_ptr(),
        out.data_ptr(), b, h, w, int(relu), int(out_dtype == torch.float32),
        xq.device.index, _stream(xq))
    _raise_on(err, "conv3x3_int8_stream")
    LAUNCHES["conv3x3_int8_stream"] += 1
    return out


def tail_conv_int8_plain(xq, kq, ks, bias=None, relu: bool = False,
                         out_dtype=torch.bfloat16):
    """Plain version of ``tail_conv_int8_stream``."""
    return conv2d_int8_q(xq, kq, ks, bias, None, relu, out_dtype)


def tail_conv_int8_stream(xq: torch.Tensor, kq: torch.Tensor, ks, bias=None,
                          relu: bool = False,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Composed-tail int8 conv: k x k zero-padded, 64 -> co channels.

    xq: (B, H, W, 64) int8; kq: (k, k, 64, co) int8 HWIO with k in {5, 7}
    and co <= 48, ks: (co,) f32, as for ``conv3x3_int8_stream``; bias:
    (co,), kept f32. The one function of the TPU's ``tail_macro8_stream_int8``
    and the XLA ``conv2d_tail_packed_int8`` (stream.py:897-905,
    conv.py:424-430).
    """
    if not _on_card(xq, kq, ks, bias):
        return tail_conv_int8_plain(xq, kq, ks, bias, relu, out_dtype)
    b, h, w, _ = xq.shape
    k, _, _, co = kq.shape
    _check(xq, "xq", torch.int8, (b, h, w, 64))
    npad = next((n for n in TAIL_NPAD if co <= n), None)
    if k not in (5, 7) or npad is None:
        raise ValueError(f"kq: expected (k, k, 64, co), k in (5, 7), "
                         f"co <= {TAIL_NPAD[-1]}; got {tuple(kq.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bfloat16 or float32, got {out_dtype}")
    _check(kq.contiguous(), "kq", torch.int8, (k, k, 64, co))
    wt = tail_slabs(kq, npad, dtype=torch.int8)
    sc = _scale32(ks, "ks", co, xq)
    bb = _bias32(bias, co, xq)
    _check(bb, "bias", torch.float32, (co,))
    out = torch.empty(b, h, w, co, dtype=out_dtype, device=xq.device)
    err = _build.load("tail_strip").tux_tail_conv_int8(
        xq.data_ptr(), wt.data_ptr(), sc.data_ptr(), bb.data_ptr(),
        out.data_ptr(), b, h, w, k, co, npad, int(relu),
        int(out_dtype == torch.float32), xq.device.index, _stream(xq))
    _raise_on(err, "tail_conv_int8_stream")
    LAUNCHES["tail_conv_int8_stream"] += 1
    return out


def _hi_lo(v: torch.Tensor):
    """f32 -> (hi, lo) bf16 halves with hi + lo == v to about 2^-17."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def tail_finish_plain(x, k_mid, b_mid, k_fin, b_fin, out_dtype=None,
                      hi_lo_fin: str = "off"):
    """Plain version of ``tail_finish_stream``: the two convs in sequence,
    with its rounding points."""
    if hi_lo_fin not in HI_LO_FIN:
        raise ValueError(f"hi_lo_fin: one of {HI_LO_FIN}, got {hi_lo_fin!r}")
    mid = _conv_f32(x.float(), k_mid.to(x.dtype).float())
    mid = mid + _bias32(b_mid, k_mid.shape[3], x)
    mid_hi, mid_lo = _hi_lo(mid)
    w_hi, w_lo = _hi_lo(k_fin.float())
    y = _conv_f32(mid_hi.float(), w_hi.float())
    if hi_lo_fin != "off":
        y = y + _conv_f32(mid_hi.float(), w_lo.float())
    if hi_lo_fin == "full":
        y = y + _conv_f32(mid_lo.float(), w_hi.float())
    y = y + _bias32(b_fin, k_fin.shape[3], x)
    return y.to(out_dtype or x.dtype)


def finish_slabs(k_fin: torch.Tensor, cmp_: int, cop: int) -> torch.Tensor:
    """A (3, 3, cm, co) f32 finish kernel as the K-major slabs that
    ``csrc/tail_strip.cu`` reads: (cop / 16 x 3 x 3 x 16, 64) bf16 rows
    (group, dx, dy, output) of 64 channels, the bf16 hi half of the weights
    (``_hi_lo``) at channels 0 .. cm - 1 and the lo half at cmp_ .. cmp_ +
    cm - 1; zero elsewhere, outputs co .. cop - 1 too. The kernel pairs the
    mid's hi half (its channels 0 .. cmp_ - 1) with either, and the mid's lo
    half (channels cmp_ .. 2 cmp_ - 1, "full") with the hi half."""
    _, _, cm, co = k_fin.shape
    k = k_fin.float()
    out = torch.zeros(cop // 16, 3, 3, 16, 64, dtype=torch.bfloat16,
                      device=k.device)
    for g in range(0, co, 16):
        n = min(16, co - g)
        src = k[..., g:g + n].permute(1, 0, 3, 2)  # dx, dy, output, channel
        hi = out[g // 16, :, :, :n, :cm]
        hi.copy_(src)  # rounded to bf16
        out[g // 16, :, :, :n, cmp_:cmp_ + cm].copy_(src - hi)
    return out.view(-1, 64)


def tail_finish_stream(x: torch.Tensor, k_mid: torch.Tensor, b_mid,
                       k_fin: torch.Tensor, b_fin, out_dtype=None,
                       hi_lo_fin: str = "off") -> torch.Tensor:
    """Split branch-B tail in one kernel: a mid conv 64 -> cm and a 3x3
    finish conv cm -> co on the mid tile, which never goes to device memory.

    x: (B, H, W, 64); k_mid: (k, k, 64, cm) HWIO with k in {3, 5}, rounded
    to x's dtype; b_mid: (cm,), kept f32; k_fin: (3, 3, cm, co) f32;
    b_fin: (co,) f32; (cm, co) padded up to (16, 16), (32, 32) or (16, 48).

    mid = conv(x, k_mid) + b_mid with zero-padded x, in f32. Mid positions
    outside the image are zero (not bias, not a conv of padding): the
    sequential two-conv zero pad. The mid is rounded once to bf16, whatever
    x's dtype. out = conv3x3(mid, k_fin) + b_fin with f32 accumulation and
    one rounding to ``out_dtype`` (default x's dtype; may be float32).
    ``hi_lo_fin``: "off" rounds k_fin to bf16; "wf" keeps it exact as
    hi + lo bf16 halves, two products summed in f32; "full" also splits the
    f32 mid into hi + lo and sums hi.hi, hi.lo and lo.hi (lo.lo dropped).
    """
    out_dtype = out_dtype or x.dtype
    if not _on_card(x, k_mid, b_mid, k_fin, b_fin):
        return tail_finish_plain(x, k_mid, b_mid, k_fin, b_fin, out_dtype,
                                 hi_lo_fin)
    if hi_lo_fin not in HI_LO_FIN:
        raise ValueError(f"hi_lo_fin: one of {HI_LO_FIN}, got {hi_lo_fin!r}")
    b, h, w, _ = x.shape
    k, _, cin, cm = k_mid.shape
    co = k_fin.shape[3]
    _check(x, "x", torch.bfloat16, (b, h, w, 64))
    pads = next((p for p in ((16, 16), (32, 32), (16, 48))
                 if cm <= p[0] and co <= p[1]), None)
    if k not in (3, 5) or k_mid.shape[1] != k or cin != 64 or pads is None \
            or tuple(k_fin.shape[:3]) != (3, 3, cm):
        raise ValueError(f"tail_finish: k_mid {tuple(k_mid.shape)} / k_fin "
                         f"{tuple(k_fin.shape)} not supported")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype: bfloat16 or float32, got {out_dtype}")
    cmp_, cop = pads
    dev = x.device
    wm = tail_slabs(k_mid, cmp_, frame=5)
    wf = finish_slabs(k_fin, cmp_, cop)
    bm, bf = _bias32(b_mid, cm, x), _bias32(b_fin, co, x)
    _check(bm, "b_mid", torch.float32, (cm,))
    _check(bf, "b_fin", torch.float32, (co,))
    out = torch.empty(b, h, w, co, dtype=out_dtype, device=dev)
    err = _build.load("tail_strip").tux_tail_finish(
        x.data_ptr(), wm.data_ptr(), bm.data_ptr(), wf.data_ptr(),
        bf.data_ptr(), out.data_ptr(), b, h, w, cm, cmp_, co, cop,
        HI_LO_FIN.index(hi_lo_fin), int(out_dtype == torch.float32),
        dev.index, _stream(x))
    _raise_on(err, "tail_finish_stream")
    LAUNCHES["tail_finish_stream"] += 1
    return out


# ---------------------------------------------------------- patch GEMMs
def _dequant(q: torch.Tensor, scale, dtype) -> torch.Tensor:
    """f32(q) * s per channel, rounded to ``dtype``."""
    s = _scale32(scale, "scale", q.shape[-1], q)
    return (q.to(torch.float32) * s).to(dtype)


def _embed_dtype(feat, in_scale, out_dtype):
    if in_scale is None:
        return feat.dtype
    return out_dtype or torch.bfloat16


def embed_plain(feat, kernel, bias=None, in_scale=None, out_dtype=None):
    """Plain version of ``embed_stream``: an f32 matmul over the patch view."""
    dt = _embed_dtype(feat, in_scale, out_dtype)
    if in_scale is not None:
        feat = _dequant(feat, in_scale, dt)
    b, h, w, c = feat.shape
    ps, _, _, d = kernel.shape
    patches = (feat.reshape(b, h // ps, ps, w // ps, ps, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(b, h // ps, w // ps, -1))
    y = patches.float() @ kernel.to(dt).float().reshape(-1, d)
    return (y + _bias32(bias, d, feat)).to(dt)


def embed_stream(feat: torch.Tensor, kernel: torch.Tensor, bias=None,
                 in_scale=None, out_dtype=None) -> torch.Tensor:
    """8x8/8 patch embed.

    feat: (B, 8 Ht, 8 Wt, 64); kernel: (8, 8, 64, D) rounded to feat's
    dtype, D % 64 == 0 on the card; bias: (D,), kept f32. Returns tokens
    (B, Ht, Wt, D) in feat's dtype.

    ``in_scale``: feat is int8, quantized per channel with this (64,)
    scale; each tap is dequantized, bf16(f32(q) * s), before its product
    (the TPU kernel's option, stream.py:317-321), and the tokens, like the
    products, are in ``out_dtype`` (default bfloat16; the card takes
    bfloat16 only).
    """
    if not _on_card(feat, kernel, bias):
        return embed_plain(feat, kernel, bias, in_scale, out_dtype)
    out = embed_launch(feat, kernel, bias, in_scale, out_dtype)
    LAUNCHES["embed_stream"] += 1
    if in_scale is not None:
        OPTION_LAUNCHES["embed_stream.int8_in"] += 1
    return out


def embed_launch(feat, kernel, bias, in_scale=None, out_dtype=None):
    """Launch the embed kernel on CUDA tensors (``embed_stream``'s checks,
    no count): the wrappers that share the kernel count their own."""
    b, h, w, _ = feat.shape
    ps, _, c, d = kernel.shape
    i8 = in_scale is not None
    _check(feat, "feat", torch.int8 if i8 else torch.bfloat16, (b, h, w, 64))
    if _embed_dtype(feat, in_scale, out_dtype) != torch.bfloat16:
        raise TypeError("embed_stream: the card's tokens are bfloat16")
    if (ps, c) != (8, 64) or kernel.shape[1] != 8 or d % 64 or h % 8 or w % 8:
        raise ValueError(f"embed: feat {tuple(feat.shape)} / kernel "
                         f"{tuple(kernel.shape)} not supported")
    wt = kernel.to(torch.bfloat16).contiguous()  # read as stored: (4096, D)
    bb = _bias32(bias, d, feat)
    _check(bb, "bias", torch.float32, (d,))
    sc = _scale32(in_scale, "in_scale", 64, feat) if i8 else None
    out = torch.empty(b, h // 8, w // 8, d, dtype=torch.bfloat16,
                      device=feat.device)
    err = _build.load("patch_gemm").tux_embed(
        feat.data_ptr(), wt.data_ptr(), bb.data_ptr(),
        None if sc is None else sc.data_ptr(), out.data_ptr(), b, h // 8,
        w // 8, d, feat.device.index, _stream(feat))
    _raise_on(err, "embed_stream")
    return out


def unembed_combine_plain(tokens, skip, kernel, bias=None,
                          relu: bool = False, feat_scale=None):
    """Plain version of ``unembed_combine_stream``."""
    b, ht, wt, d = tokens.shape
    _, ps, _, c = kernel.shape
    g = tokens.float() @ kernel.to(tokens.dtype).float().reshape(d, -1)
    g = (g.reshape(b, ht, wt, ps, ps, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, ht * ps, wt * ps, c))
    sk = (skip.float() if feat_scale is None
          else _dequant(skip, feat_scale, torch.float32))
    y = g + _bias32(bias, c, tokens) + sk
    if relu:
        y = torch.relu(y)
    return y.to(tokens.dtype)


def unembed_combine_stream(tokens: torch.Tensor, skip: torch.Tensor,
                           kernel: torch.Tensor, bias=None,
                           relu: bool = False,
                           feat_scale=None) -> torch.Tensor:
    """8x8 patch unembed plus the skip add: ``act(unembed(tokens) + skip)``.

    tokens: (B, Ht, Wt, D); skip: (B, 8 Ht, 8 Wt, 64); kernel: (D, 8, 8, 64)
    rounded to tokens' dtype, D % 16 == 0 and D <= 512 on the card; bias:
    (64,), kept f32.
    The skip is added in f32 before the one rounding, as (g + bias) + skip.
    Returns (B, 8 Ht, 8 Wt, 64) in tokens' dtype.

    ``feat_scale``: skip is int8, quantized per channel with this (64,)
    scale, and adds as f32(q) * s (the TPU kernel's option,
    stream.py:229-236).
    """
    if not _on_card(tokens, skip, kernel, bias):
        return unembed_combine_plain(tokens, skip, kernel, bias, relu,
                                     feat_scale)
    out = unembed_launch(tokens, skip, kernel, bias, relu, feat_scale)
    LAUNCHES["unembed_combine_stream"] += 1
    if feat_scale is not None:
        OPTION_LAUNCHES["unembed_combine_stream.int8_skip"] += 1
    return out


def unembed_launch(tokens, skip, kernel, bias, relu: bool = False,
                   feat_scale=None, round_steps: bool = False):
    """Launch the unembed kernel on CUDA tensors (``unembed_combine_stream``'s
    checks, no count). ``round_steps``: the epilogue of the archived
    ``fused_patch_unembed_add`` instead of the one f32 epilogue: bf16(acc),
    then + bias in bf16, then + skip in bf16 (the bias must then be bf16
    values)."""
    b, ht, wt_, d = tokens.shape
    i8 = feat_scale is not None
    _check(tokens, "tokens", torch.bfloat16, (b, ht, wt_, d))
    _check(skip, "skip", torch.int8 if i8 else torch.bfloat16,
           (b, 8 * ht, 8 * wt_, 64))
    if tuple(kernel.shape) != (d, 8, 8, 64) or d % 16 or d > 512:
        raise ValueError(f"unembed: kernel {tuple(kernel.shape)} not "
                         f"supported for D={d}")
    wt = kernel.to(torch.bfloat16).contiguous()  # read as stored: (D, 4096)
    bb = _bias32(bias, 64, tokens)
    _check(bb, "bias", torch.float32, (64,))
    sc = _scale32(feat_scale, "feat_scale", 64, tokens) if i8 else None
    out = torch.empty(b, 8 * ht, 8 * wt_, 64, dtype=torch.bfloat16,
                      device=tokens.device)
    err = _build.load("patch_gemm").tux_unembed_combine(
        tokens.data_ptr(), wt.data_ptr(), bb.data_ptr(), skip.data_ptr(),
        None if sc is None else sc.data_ptr(), out.data_ptr(), b, ht, wt_,
        d, int(relu), int(round_steps), tokens.device.index, _stream(tokens))
    _raise_on(err, "unembed_combine_stream")
    return out
