"""NHWC convolution, its int8 form and the composition of two convs into
one.

JAX counterpart: transformerupscaler_tpu ops/conv.py:36 (``conv2d``),
:336-460 (the int8 convs, ``conv2d_int8``) and :653
(``compose_conv3x3_kernels``). ``conv2d`` runs the convs the JAX package
leaves to XLA: the models' exact paths, and on the serving paths conv1
(3 -> 64 channels), the stride-2 downsample and the last decoder conv; the
64 -> 64 convs of the serving paths run the kernels in
``transformerupscaler_torch.kernels.stream``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride: int = 1,
           padding: int = 1, relu: bool = False) -> torch.Tensor:
    """Zero-padded conv. x: NHWC; kernel: HWIO. With ``padding`` on every side
    the output extent is floor((n + 2 padding - k) / stride) + 1, PyTorch's
    rule, which the JAX op's explicit padding reproduces.

    Like the JAX op, the conv runs in x's dtype (f32 accumulation inside),
    its result is rounded to that dtype, and the bias is added and the ReLU
    applied in that dtype.
    """
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(x.dtype)
    if relu:
        out = torch.relu(out)
    return out.contiguous()


def conv2d_int8_q(xq: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                  bias=None, padding: int | None = None, relu: bool = False,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Integer conv with quantized weights and its f32 epilogue.

    xq: (B, H, W, Cin) int8; kq: (k, k, Cin, O) int8 HWIO; ks: (O,) f32
    weight scales; bias: (O,), added in f32; ``padding`` zero pixels on
    every side (default (k - 1) // 2, the same extent). The sum of int8
    products is taken in float64, where it is exact in any order (a 7x7
    sum over 64 channels reaches 49 * 64 * 127^2, past f32's 2^24), and
    rounded once to f32 as the reference's ``acc.astype(f32)`` rounds its
    int32; then y = acc * ks + bias in f32, two roundings, no fused
    multiply-add; ReLU; one rounding to ``out_dtype``.
    """
    k = kq.shape[0]
    pad = (k - 1) // 2 if padding is None else padding
    xp = F.pad(xq.to(torch.float64), (0, 0, pad, pad, pad, pad))
    ho, wo = xp.shape[1] - k + 1, xp.shape[2] - k + 1
    w64 = kq.to(torch.float64)
    acc = torch.zeros(*xq.shape[:1], ho, wo, kq.shape[3],
                      dtype=torch.float64, device=xq.device)
    for dy in range(k):
        for dx in range(k):
            acc += xp[:, dy:dy + ho, dx:dx + wo, :] @ w64[dy, dx]
    y = acc.to(torch.float32) * ks.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact: ``torch._int_mm``.
    On the card cuBLAS wants M > 16 and N a multiple of 8: a and b are
    padded with zeros to that and the result cut back."""
    m, n = a.shape[0], b.shape[1]
    if a.is_cuda:
        if a.shape[1] % 8:
            raise ValueError(f"int_mm: K {a.shape[1]} is not a multiple of 8")
        a = F.pad(a, (0, 0, 0, max(0, 17 - m)))
        b = F.pad(b, (0, -n % 8))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def conv2d_int8_mm(xq: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                   bias=None, padding: int | None = None, relu: bool = False,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """``conv2d_int8_q``'s function with the sums in int32: the k x k
    patches of the zero-padded int8 input gathered once (im2col, k k Cin
    bytes a pixel) and one ``int_mm`` with the (k k Cin, O) weights. For
    the composed tails with more outputs than the int8 tail kernel takes
    (x6: 64 -> 108), which the JAX package runs on XLA."""
    k = kq.shape[0]
    pad = (k - 1) // 2 if padding is None else padding
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    b, ho, wo = xq.shape[0], xp.shape[1] - k + 1, xp.shape[2] - k + 1
    # (B, Ho, Wo, C, dy, dx) -> rows (dy, dx, c), the order of kq's rows.
    cols = xp.unfold(1, k, 1).unfold(2, k, 1).permute(0, 1, 2, 4, 5, 3)
    acc = int_mm(cols.reshape(b * ho * wo, -1),
                 kq.reshape(-1, kq.shape[3]))
    y = acc.to(torch.float32) * ks.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype).reshape(b, ho, wo, -1)


def conv2d_int8(xq: torch.Tensor, kernel: torch.Tensor, x_scale, bias=None,
                padding: int | None = None, relu: bool = False,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Int8 conv of an input quantized per input channel with ``x_scale``.

    NHWC counterpart of the JAX package's three int8 convs, which compute
    this one function in their layouts: ``conv2d_packed_int8``
    (ops/conv.py:336-382, the 3x3 on the width-2 packed layout),
    ``conv2d_tail_packed_int8`` (:419-460, the composed tails on the macro
    block layout) and ``conv2d_int8`` (:385-416, NHWC with explicit
    padding). ``kernel`` is the raw float HWIO kernel: the activation scale
    folds into it in f32 and the result is quantized per output channel
    (``ops.quant.fold_conv_kernel``), then ``conv2d_int8_mm``. The offline
    GPTQ weights (``pre_q``) are not ported.
    """
    from transformerupscaler_torch.ops.quant import fold_conv_kernel

    kq, ks = fold_conv_kernel(kernel, x_scale)
    return conv2d_int8_mm(xq, kq, ks, bias, padding, relu, out_dtype)


def conv2d_uint8_exact(x_in: torch.Tensor, kernel: torch.Tensor, bias=None,
                       relu: bool = False,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """``serve_quality``'s exact-uint8 conv1 (JAX ``conv2d_packed_dots_deint``
    with ``k_hi_lo`` and ``pre_scale=1/255``, ops/conv.py:152-286; the model
    calls it at fast_transformer.py:563-579): the f32 input x_in goes in as
    bf16(x_in * 255), exact for the integers of a uint8 frame, and the
    kernel times 1/255, in f32, splits into bf16 hi and lo halves; the two
    convs sum in f32 and add, then the f32 bias, the ReLU and one rounding
    to ``out_dtype``. Every operand is a bf16 value, which TF32 holds
    exactly, so cuDNN's TF32 default changes nothing here."""
    xq = (x_in.to(torch.float32) * 255.0).to(torch.bfloat16).float()
    k32 = kernel.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                                  dtype=torch.float32)
    k_hi = k32.to(torch.bfloat16).float()
    k_lo = (k32 - k_hi).to(torch.bfloat16).float()
    y = conv2d(xq, k_hi) + conv2d(xq, k_lo)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def compose_conv3x3_kernels(k1: torch.Tensor, b1, k2: torch.Tensor, b2):
    """Compose two correlation kernels into one.

    ``conv(conv(x, k1), k2)`` == ``conv(x, k_comp)`` everywhere except a
    border ring: the sequential form zero-pads the intermediate, the
    composed form zero-pads the input.

    k1: (a, a, C, M); k2: (b, b, M, O) -> (a+b-1, a+b-1, C, O). Returns
    (k_comp, b_comp); b_comp folds k2 applied to the constant b1, plus b2,
    and is None when both biases are.
    """
    a, b = k1.shape[0], k2.shape[0]
    n = a + b - 1
    c, o = k1.shape[2], k2.shape[3]
    prod = torch.einsum("pqcm,stmo->pqstco", k1, k2)
    kc = torch.zeros(n, n, c, o, dtype=k1.dtype, device=k1.device)
    for p in range(a):
        for q in range(a):
            kc[p:p + b, q:q + b] += prod[p, q]
    bc = None
    if b1 is not None or b2 is not None:
        bc = torch.zeros(o, dtype=k1.dtype, device=k1.device)
        if b1 is not None:
            bc = bc + torch.einsum("stmo,m->o", k2, b1.to(k2.dtype))
        if b2 is not None:
            bc = bc + b2.to(k1.dtype)
    return kc, bc
