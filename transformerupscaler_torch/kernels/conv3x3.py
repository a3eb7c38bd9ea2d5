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
tests call it). The same kernel serves ``kernels.stream.conv3x3_stream``
(the serving 64 -> 64 conv, with its own rounding points and an int8
output), which counts its own launches.

Given CPU tensors the wrapper computes the plain version (any float dtype);
given CUDA tensors it takes bf16 only, launches the kernel and adds one to
``ARCHIVED_LAUNCHES["conv3x3"]``; it never falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    c8, c16 = _round_up(c, 8), _round_up(c, 16)
    o8, o64 = _round_up(o, 8), _round_up(o, 64)
    # TMA reads rows of whole 16-byte units: a width that is no multiple of
    # 8 is padded with zero channels (a copy, for such widths only).
    xk = x if c == c8 else F.pad(x, (0, c8 - c))
    wt = torch.zeros(9, c16, o64, dtype=torch.bfloat16, device=x.device)
    wt[:, :c, :o] = kernel.to(torch.bfloat16).reshape(9, c, o)
    bb = torch.zeros(o64, dtype=torch.float32, device=x.device)
    if bias is not None:
        if tuple(bias.shape) != (o,):
            raise ValueError(f"conv3x3: bias {tuple(bias.shape)} for {o} "
                             f"outputs")
        bb[:o] = bias.to(torch.bfloat16).float()
    out = torch.empty(b, h, w, o8, dtype=torch.bfloat16, device=x.device)
    err = _build.load("conv3x3").tux_conv3x3_any(
        xk.data_ptr(), wt.data_ptr(), bb.data_ptr(), None, out.data_ptr(), b,
        h, w, c8, c16, o8, o64, int(relu), x.device.index, stream_of(x))
    raise_on(err, "conv3x3")
    ARCHIVED_LAUNCHES["conv3x3"] += 1
    return out if o == o8 else out[..., :o].contiguous()


def desc_shift_probe(a: torch.Tensor, b: torch.Tensor,
                     shift: int) -> torch.Tensor:
    """The wgmma descriptor shift the kernel's A operand rests on, alone:
    a (72, 64) and b (64, 64) bf16 on the card; returns a[shift : shift +
    64] @ b in f32, computed by one wgmma warpgroup from a 128B-swizzled
    tile read at a start address ``shift`` rows of 128 bytes in."""
    check(a, "a", torch.bfloat16, (72, 64))
    check(b, "b", torch.bfloat16, (64, 64))
    d = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    err = _build.load("conv3x3").tux_conv3x3_desc_probe(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), shift, a.device.index,
        stream_of(a))
    raise_on(err, "conv3x3 descriptor probe")
    return d


def desc_shift_probe_i8(a: torch.Tensor, b: torch.Tensor,
                        shift: int) -> torch.Tensor:
    """The int8 kernels' A operand shift, alone: a (72, 64) and b (64, 64)
    int8 on the card (b as 64 rows of K); returns a[shift : shift + 64] @
    b.T in int32, computed by one int8 wgmma warpgroup from a 64B-swizzled
    tile read at a start address ``shift`` rows of 64 bytes in."""
    check(a, "a", torch.int8, (72, 64))
    check(b, "b", torch.int8, (64, 64))
    d = torch.empty(64, 64, dtype=torch.int32, device=a.device)
    err = _build.load("conv3x3").tux_conv3x3_i8_desc_probe(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), shift, a.device.index,
        stream_of(a))
    raise_on(err, "conv3x3 int8 descriptor probe")
    return d
