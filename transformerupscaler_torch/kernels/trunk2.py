"""The fused window trunk: every window block in one Hopper kernel, its
wrapper, its plain PyTorch version and the stacking of the blocks' weights.

=====================  =====================  ===============================
wrapper                CUDA source            TPU kernel it replaces
=====================  =====================  ===============================
``fused_window_trunk`` csrc/window_trunk.cu   ops/pallas/trunk2.py:524
                                              ``fused_window_trunk_v2``
=====================  =====================  ===============================

The TPU function has five kernel bodies (trunk2.py:51, :105, :255, :335,
:432) that tile the same arithmetic in five ways for the MXU; one CUDA
kernel answers for all of them. The rounding points, with ``dt`` the
activations' dtype (bf16 on the card), are those of ``_trunk2_pair_kernel``
(trunk2.py:187-252) and the plain version has the same ones:

- every stacked parameter is cast to ``dt`` first, LayerNorm scales and
  shifts and all biases included; the relative-position bias stays f32;
- LayerNorm: f32 mean, var = E[x^2] - mean^2 (not clamped), eps 1e-5, the
  affine in f32, one rounding to ``dt``;
- qkv, proj, fc1, fc2: ``dt`` operands, f32 accumulation, rounded to ``dt``,
  then the bias added in ``dt`` (a second rounding);
- q * head_dim^-0.5 in ``dt``; scores f32 plus the f32 bias; softmax in f32
  per window and head; probabilities rounded to ``dt``; P.V accumulated in
  f32 and rounded to ``dt``;
- residual adds in ``dt``;
- GELU in f32 as 0.5 x (1 + erf(x / sqrt 2)), one rounding to ``dt``.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel, adds one to ``LAUNCHES["fused_window_trunk"]`` and
never falls back.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import (
    LAUNCHES,
    check,
    on_card,
    raise_on,
    stream_of,
)
from transformerupscaler_torch.ops.relpos import gather_relative_bias

# What the CUDA kernel is compiled for.
TOKENS, DIM, HEADS, HIDDEN = 64, 192, 12, 768
SLAB_N, SLAB_K = 64, 192  # one streamed weight slab: 64 outputs x 192 inputs
EPS = 1e-5


def stack_trunk_params(blocks, dtype) -> dict[str, torch.Tensor]:
    """Stack the ``WindowBlock`` modules' parameters over layers, cast to
    ``dtype`` (JAX: the ``stack`` closure and the bias gather of
    trunk2.py:573-599).

    Returns (L = layers, C = dim, H = hidden): ``ln1s, ln1b, ln2s, ln2b,
    projb, fc2b`` (L, C); ``qkvb`` (L, 3C); ``fc1b`` (L, H); ``qkvw``
    (L, C, 3C), ``projw`` (L, C, C), ``fc1w`` (L, C, H), ``fc2w`` (L, H, C)
    as (in, out); ``bias`` (L, heads, n, n) f32; ``heads``. At the widths
    the CUDA kernel takes, also its two packed operands: ``wpack``
    (L, 36, 64, 192), each layer's GEMM weights cut into the slabs
    [64 outputs][192 inputs] that the kernel streams, in the order it
    consumes them (qkv 9, proj 3, fc1 12, then fc2 as 3 output chunks x 4
    input chunks), and ``vpack`` (L, 2496): ln1s, ln1b, qkvb, projb, ln2s,
    ln2b, fc1b, fc2b side by side.
    """
    def stack(get):
        return torch.stack([get(b).to(dtype) for b in blocks]).contiguous()

    ws = blocks[0].attn.window_size
    p = {
        "ln1s": stack(lambda b: b.norm1.scale),
        "ln1b": stack(lambda b: b.norm1.bias),
        "qkvw": stack(lambda b: b.attn.qkv_kernel),
        "qkvb": stack(lambda b: b.attn.qkv_bias),
        "projw": stack(lambda b: b.attn.proj_kernel),
        "projb": stack(lambda b: b.attn.proj_bias),
        "ln2s": stack(lambda b: b.norm2.scale),
        "ln2b": stack(lambda b: b.norm2.bias),
        "fc1w": stack(lambda b: b.mlp_fc1.kernel),
        "fc1b": stack(lambda b: b.mlp_fc1.bias),
        "fc2w": stack(lambda b: b.mlp_fc2.kernel),
        "fc2b": stack(lambda b: b.mlp_fc2.bias),
        "bias": torch.stack([
            gather_relative_bias(b.attn.bias_table.float(), ws)
            for b in blocks]).contiguous(),
        "heads": blocks[0].attn.num_heads,
    }
    layers, c, hidden = p["fc1w"].shape
    if (ws * ws, c, p["heads"], hidden) == (TOKENS, DIM, HEADS, HIDDEN):
        def slabs(w):  # (L, in, out) -> (L, out/64 * in/192, 64, 192)
            k, n = w.shape[1:]
            w = w.transpose(1, 2).reshape(layers, n // SLAB_N, SLAB_N,
                                          k // SLAB_K, SLAB_K)
            return w.permute(0, 1, 3, 2, 4).reshape(layers, -1, SLAB_N, SLAB_K)

        p["wpack"] = torch.cat([slabs(p[k]) for k in
                                ("qkvw", "projw", "fc1w", "fc2w")],
                               dim=1).contiguous()
        p["vpack"] = torch.cat([p[k] for k in (
            "ln1s", "ln1b", "qkvb", "projb", "ln2s", "ln2b", "fc1b",
            "fc2b")], dim=1).contiguous()
    return p


def _layernorm(x, scale, shift):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + EPS)
    return (y * scale.float() + shift.float()).to(x.dtype)


def _dense(x, w, b):
    """f32-accumulated product rounded to x's dtype, then the bias added in
    that dtype."""
    return (x.float() @ w.float()).to(x.dtype) + b


def fused_window_trunk_plain(win: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain version of ``fused_window_trunk``; any widths."""
    nw, n, c = win.shape
    dt = win.dtype
    heads = params["heads"]
    hd = c // heads
    x = win
    for l in range(params["qkvw"].shape[0]):
        y = _layernorm(x, params["ln1s"][l], params["ln1b"][l])
        qkv = _dense(y, params["qkvw"][l], params["qkvb"][l])
        q, k, v = (t.reshape(nw, n, heads, hd).transpose(1, 2)
                   for t in qkv.split(c, dim=-1))  # (nW, heads, n, hd)
        q = q * torch.tensor(hd ** -0.5, dtype=dt)
        s = q.float() @ k.float().transpose(-1, -2) + params["bias"][l]
        prob = torch.softmax(s, dim=-1).to(dt)
        ctx = (prob.float() @ v.float()).to(dt)
        ctx = ctx.transpose(1, 2).reshape(nw, n, c)
        x = x + _dense(ctx, params["projw"][l], params["projb"][l])
        y = _layernorm(x, params["ln2s"][l], params["ln2b"][l])
        hf = _dense(y, params["fc1w"][l], params["fc1b"][l]).float()
        hid = (0.5 * hf * (1.0 + torch.erf(hf * 2.0 ** -0.5))).to(dt)
        x = x + _dense(hid, params["fc2w"][l], params["fc2b"][l])
    return x


def fused_window_trunk(win: torch.Tensor, params: dict) -> torch.Tensor:
    """All window blocks on window tokens.

    win: (nW, 64, 192) windows of 8x8 tokens; params: what
    ``stack_trunk_params(blocks, win.dtype)`` returns, for 12 heads and
    hidden 768 on the card; any number of layers and windows. Returns the
    same shape and dtype.
    """
    tensors = [v for v in params.values() if isinstance(v, torch.Tensor)]
    if not on_card(win, *tensors):
        return fused_window_trunk_plain(win, params)
    nw = win.shape[0]
    if "wpack" not in params:
        raise ValueError(
            f"fused_window_trunk: the kernel takes {TOKENS} tokens, dim "
            f"{DIM}, {HEADS} heads, hidden {HIDDEN}; got fc1 "
            f"{tuple(params['fc1w'].shape[1:])}, {params['heads']} heads")
    layers = params["wpack"].shape[0]
    check(win, "win", torch.bfloat16, (nw, TOKENS, DIM))
    check(params["wpack"], "wpack", torch.bfloat16,
          (layers, 36, SLAB_N, SLAB_K))
    check(params["vpack"], "vpack", torch.bfloat16, (layers, 2496))
    check(params["bias"], "bias", torch.float32,
          (layers, HEADS, TOKENS, TOKENS))
    out = torch.empty_like(win)
    err = _build.load("window_trunk").tux_window_trunk(
        win.data_ptr(), params["wpack"].data_ptr(),
        params["vpack"].data_ptr(), params["bias"].data_ptr(),
        out.data_ptr(), nw, layers, win.device.index, stream_of(win))
    raise_on(err, "fused_window_trunk")
    LAUNCHES["fused_window_trunk"] += 1
    return out
