"""NHWC convolution and the composition of two convs into one.

JAX counterpart: transformerupscaler_tpu ops/conv.py:36 (``conv2d``) and
:653 (``compose_conv3x3_kernels``). ``conv2d`` runs the convs the JAX package
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
