"""The general NHWC 3x3 conv of the JAX package's archived
``ops/pallas/conv3x3.py``, its wrapper and its plain PyTorch version.

=============  ==================  =========================================
wrapper        CUDA source         TPU kernel it replaces
=============  ==================  =========================================
``conv3x3``    csrc/conv3x3.cu     ops/pallas/conv3x3.py:73 ``conv3x3_pallas``
=============  ==================  =========================================

Stride 1, zero padding 1, any batch, height, width, input width C and
output width O, an optional bias and ReLU. Its rounding points are the TPU
kernel's, which differ from ``conv3x3_stream``'s: the kernel and the bias
are rounded to x's dtype first (conv3x3.py:98, 103-104), the products
accumulate in f32, the bias adds in f32, then the ReLU, then one rounding
to x's dtype. No model reaches it (the JAX package kept it as a record; its
tests call it).

Given CPU tensors the wrapper computes the plain version (any float dtype);
given CUDA tensors it takes bf16 only, launches the kernel and adds one to
``ARCHIVED_LAUNCHES["conv3x3"]``; it never falls back.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import (
    ARCHIVED_LAUNCHES,
    check,
    on_card,
    raise_on,
    stream_of,
)
from transformerupscaler_torch.kernels.stream import _conv_f32


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv3x3_plain(x, kernel, bias=None, relu: bool = False):
    """Plain version of ``conv3x3``: f32 products of the dtype-rounded
    operands, one matmul per tap."""
    dt = x.dtype
    y = _conv_f32(x.float(), kernel.to(dt).float())
    if bias is not None:
        y = y + bias.to(dt).float()
    if relu:
        y = torch.relu(y)
    return y.to(dt)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias=None,
            relu: bool = False, th: int | None = None,
            tw: int | None = None) -> torch.Tensor:
    """3x3 zero-padded conv, any widths: x (B, H, W, C), kernel (3, 3, C, O)
    HWIO, bias (O,) or None. Returns (B, H, W, O) in x's dtype.

    ``th`` and ``tw`` are the TPU kernel's row and column tiles; they are
    accepted and ignored."""
    del th, tw
    if not on_card(x, kernel, bias):
        return conv3x3_plain(x, kernel, bias, relu)
    b, h, w, c = x.shape
    check(x, "x", torch.bfloat16, (b, h, w, c))
    if tuple(kernel.shape[:3]) != (3, 3, c) or kernel.dim() != 4:
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} for {c} "
                         f"input channels")
    o = kernel.shape[3]
    c16, o8 = _round_up(c, 16), _round_up(o, 8)
    wt = torch.zeros(9, o8, c16, dtype=torch.bfloat16, device=x.device)
    wt[:, :o, :c] = kernel.to(torch.bfloat16).reshape(9, c, o).transpose(1, 2)
    bb = torch.zeros(o8, dtype=torch.float32, device=x.device)
    if bias is not None:
        if tuple(bias.shape) != (o,):
            raise ValueError(f"conv3x3: bias {tuple(bias.shape)} for {o} "
                             f"outputs")
        bb[:o] = bias.to(torch.bfloat16).float()
    out = torch.empty(b, h, w, o, dtype=torch.bfloat16, device=x.device)
    err = _build.load("conv3x3").tux_conv3x3_any(
        x.data_ptr(), wt.data_ptr(), bb.data_ptr(), out.data_ptr(), b, h, w,
        c, c16, o, o8, int(relu), x.device.index, stream_of(x))
    raise_on(err, "conv3x3")
    ARCHIVED_LAUNCHES["conv3x3"] += 1
    return out
