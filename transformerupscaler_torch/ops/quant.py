"""Int8 quantization: the fused trunk's rowwise and static modes and the
int8 serving scopes' convs.

The port's own copy of what it needs from the JAX package:

- the trunk's rowwise mode: the weights as ``quantize_gemm_weights``
  (transformerupscaler_tpu/ops/pallas/trunk2.py:506) quantizes them, with
  the rowwise scale of trunk2.py:724-734, and the per-token activation
  quantize of trunk2.py:176-178;
- the trunk's static mode: ``quantize_gemm_weights`` with calibrated
  per-input-channel activation scales folded into the weights, and the
  per-channel activation quantize of trunk2.py:182;
- the reference's ``--quantize`` (``UpscalerEngine(quantize=True)``):
  ``quantize_linear_params`` with ``_fake_quant`` (ops/quant.py:22-56), in
  numpy on the parameter tree, bit for bit;
- the int8 serving scopes (models/fast_transformer.py:379-398, 495-507):
  ``quantize_conv_kernel``, ``quantize_act`` and ``quantize_act_ch``
  (ops/quant.py:85-130), the dynamic per-channel activation scale of
  ``act_q`` / ``tail_scale`` and the fold of an activation scale into a
  conv kernel before its weights are quantized (ops/conv.py:368-371);
- ``int8_mlp``: ``quantize_weight`` and ``int8_dense`` (ops/quant.py:59-84),
  the int8 MLP of the window blocks.

Symmetric, round half to even (``torch.round`` as ``jnp.round``), every
step in f32 as there; the serving scopes divide by 127 as a true division
on the card too (``div127``), so their scales and weights are the CPU's.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


# Parents of the 2-D ``kernel`` leaves that are linear layers (the torch
# {nn.Linear} set); the projections are named by their own keys.
_LINEAR_PARENTS = {"attn", "mlp_fc1", "mlp_fc2"}
_LINEAR_KERNELS = {"qkv_kernel", "proj_kernel", "in_kernel", "out_kernel"}


def _fake_quant(w: np.ndarray) -> np.ndarray:
    """Symmetric per-output-channel int8 round trip of an (in, out) kernel."""
    w = np.asarray(w)
    scale = np.max(np.abs(w), axis=0, keepdims=True) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127)
    return (q * scale).astype(w.dtype)


def quantize_linear_params(params: dict) -> dict:
    """A copy of the parameter tree with every linear kernel (attention and
    MLP projections, never a conv) int8-round-tripped per output channel:
    the accuracy effect of torch's dynamic quantization of nn.Linear."""

    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, parent=k)
            elif np.ndim(v) == 2 and (
                    k in _LINEAR_KERNELS
                    or (k == "kernel" and parent in _LINEAR_PARENTS)):
                out[k] = _fake_quant(np.asarray(v))
            else:
                out[k] = v
        return out

    return walk(dict(params))


def _f32(v: float) -> torch.Tensor:
    """A Python constant as the f32 value a weakly typed JAX scalar takes."""
    return torch.tensor(v, dtype=_F32)


def _f32_on(v: float, device) -> torch.Tensor:
    """``_f32(v)`` made on ``device`` by a fill, not copied from the host:
    a CUDA graph cannot capture a copy from pageable host memory."""
    return torch.full((), v, dtype=_F32, device=device)


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, a true f32 division on x's device. PyTorch multiplies a CUDA
    tensor by the reciprocal of a CPU scalar divisor, one rounding apart
    from the CPU's (and JAX's) quotient; a divisor on the device divides."""
    return x / _f32_on(127.0, x.device)


def rowwise_weights(wstack: torch.Tensor):
    """(wq int8 (L, k, n), sw f32 (L, n)) from stacked (L, k, n) GEMM
    weights (as ``dt`` values), per output channel: sw0 = max(max_k |w| /
    127, 1e-8), wq = clip(round(w / sw0), -127, 127). The per-row
    activation scale applies at run time, so the static path's /127 is
    undone as the reference undoes it: sw = (sw0 / 127) * 127 in f32, which
    is not always sw0."""
    wf = wstack.to(_F32)
    sw = torch.maximum(wf.abs().amax(dim=1) / _f32(127.0), _f32(1e-8))
    wq = torch.clamp(torch.round(wf / sw[:, None]), -127, 127)
    return wq.to(torch.int8), (sw / _f32(127.0)) * _f32(127.0)


def static_gemm_weights(wstack: torch.Tensor, s_in: torch.Tensor):
    """The static mode's weights from stacked (L, k, n) GEMM weights (as
    ``dt`` values) and the (L, k) per-input-channel activation scales
    ``s_in``: wf = w * s_in folded in f32, per output channel sw0 =
    max(max_k |wf| / 127, 1e-8), wq = clip(round(wf / sw0), -127, 127).
    Returns (wq int8 (L, k, n), sw = sw0 / 127 f32 (L, n), ia = 127 /
    max(s_in, 1e-8) f32 (L, k)): the activations quantize as clip(round(x *
    ia), -127, 127) and the product dequantizes as float(acc) * sw."""
    s = torch.as_tensor(s_in, dtype=_F32, device=wstack.device)
    wf = wstack.to(_F32) * s[:, :, None]
    sw = torch.maximum(wf.abs().amax(dim=1) / _f32(127.0), _f32(1e-8))
    wq = torch.clamp(torch.round(wf / sw[:, None]), -127, 127)
    ia = _f32(127.0) / torch.maximum(s, _f32(1e-8))
    return wq.to(torch.int8), sw / _f32(127.0), ia


def quantize_static(x: torch.Tensor, ia: torch.Tensor) -> torch.Tensor:
    """clip(round(f32(x) * ia), -127, 127) per channel (last axis), as float
    values: the static mode's activation quantize (trunk2.py:182)."""
    return torch.clamp(torch.round(x.to(_F32) * ia), -127, 127)


def quantize_rows(x: torch.Tensor):
    """(xq, srow): per token row of ``x`` (..., k), srow = max(max|x_row|,
    1e-6) * (1/127) in f32 and xq = round_half_even(x * (1 / srow)), as
    float values in [-127, 127]; srow keeps a trailing axis of 1."""
    xf = x.to(_F32)
    srow = torch.maximum(xf.abs().amax(dim=-1, keepdim=True),
                         _f32(1e-6)) * _f32(1.0 / 127.0)
    return torch.round(xf * torch.reciprocal(srow)), srow


def quantize_weight(w: torch.Tensor):
    """(in, out) float -> (int8 kernel, (1, out) scale): scale = max|w| over
    the inputs / 127, 1 where that is 0; q = clip(round(w / scale), -127,
    127); in w's dtype."""
    scale = div127(w.abs().amax(dim=0, keepdim=True))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               bias=None) -> torch.Tensor:
    """y = dequant(quant(x) @ w_q) + bias with an int8 product.

    x: (..., in) float; w_q: (in, out) int8; w_scale: (1, out) f32. The
    activations quantize per tensor, in x's dtype as the reference computes
    them: x_scale = max(max|x|, 1e-8) / 127 (a bf16 scale under a bf16
    model), x_q = clip(round(x / x_scale), -127, 127). The int32 product is
    ``ops.conv.int_mm``; then float(acc) * (x_scale * w_scale) in f32, the
    scale product formed first, + bias in f32, one cast to x's dtype."""
    from transformerupscaler_torch.ops.conv import int_mm

    dt = x.dtype
    floor = torch.full((), 1e-8, dtype=dt, device=x.device)
    x_scale = torch.maximum(x.abs().amax(), floor) / torch.full(
        (), 127.0, dtype=dt, device=x.device)
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    acc = int_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    y = acc.to(_F32) * (x_scale.to(_F32) * w_scale.to(_F32))
    if bias is not None:
        y = y + bias.to(_F32)
    return y.to(dt).reshape(*x.shape[:-1], w_q.shape[1])


def quantize_conv_kernel(k: torch.Tensor):
    """HWIO conv kernel -> (int8 kernel, per-output-channel (O,) scale):
    scale = max|k| over (H, W, I) / 127, 1 where that is 0; q = clip(round(k
    / scale), -127, 127). Computed in k's dtype, as the reference does."""
    scale = div127(k.abs().amax(dim=(0, 1, 2)))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(k / scale), -127, 127)
    return q.to(torch.int8), scale


def fold_conv_kernel(kernel: torch.Tensor, x_scale):
    """The int8 weights of a conv whose input was quantized with the
    per-input-channel (or scalar) ``x_scale``: the scale folds into the f32
    kernel, keff = kernel * x_scale, and keff is quantized per output
    channel (``quantize_conv_kernel``). Returns (kq int8 HWIO, ks f32 (O,)),
    so that conv(q, kernel) ~ ks * conv_int(q, kq)."""
    s = torch.as_tensor(x_scale, dtype=_F32, device=kernel.device)
    return quantize_conv_kernel(kernel.to(_F32) * s.reshape(1, 1, -1, 1))


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic per-channel activation scale of the int8 scopes: the
    abs-max of each channel (last axis) over every pixel and the batch,
    max(m, 1e-8) / 127 in f32. (JAX takes the maximum over the two pixel
    parities of its packed layout too: in NHWC that is the channel
    maximum.) One pass over x in its own dtype: its minimum and maximum
    per channel, whose magnitudes are exact in any float type."""
    lo, hi = torch.aminmax(x.reshape(-1, x.shape[-1]), dim=0)
    m = torch.maximum(-lo, hi).to(_F32)
    return div127(torch.maximum(m, _f32_on(1e-8, x.device)))


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(f32(x) / scale), -127, 127) as int8; the division
    promotes x to f32 as it reads it, with no f32 copy of x (a scale with
    no dimension would not promote it: it is given one)."""
    q = torch.round(x / scale.reshape(-1))
    return q.clamp_(-127, 127).to(torch.int8)


def quantize_act(x: torch.Tensor, scale=None):
    """Symmetric per-tensor int8 activation quant: (q, scale) with scale =
    max(max|x|, 1e-8) / 127 when not given, q = clip(round(x / scale),
    -127, 127)."""
    if scale is None:
        scale = div127(torch.maximum(x.to(_F32).abs().amax(),
                                     _f32_on(1e-8, x.device)))
    scale = torch.as_tensor(scale, dtype=_F32, device=x.device)
    return _quantize(x, scale), scale


def quantize_act_ch(x: torch.Tensor, scale=None):
    """Symmetric per-channel (last axis) int8 activation quant: (q, scale)
    with ``act_scale(x)`` when no scale is given, q = clip(round(x /
    scale), -127, 127) with a division, as the reference writes it (the
    conv epilogue's quantize multiplies by 1 / scale instead)."""
    if scale is None:
        scale = act_scale(x)
    scale = torch.as_tensor(scale, dtype=_F32, device=x.device)
    return _quantize(x, scale), scale
