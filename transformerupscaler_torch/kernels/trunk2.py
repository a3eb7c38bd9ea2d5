"""The fused window trunk: every window block in one Hopper kernel, its
wrapper, its plain PyTorch versions and the stacking of the blocks' weights.

=====================  =====================  ===============================
wrapper                CUDA source            TPU kernels it replaces
=====================  =====================  ===============================
``fused_window_trunk`` csrc/window_trunk.cu   ops/pallas/trunk2.py:524
                                              ``fused_window_trunk_v2`` (mode
                                              "v2"; "int8_rowwise" is its
                                              ``int8_acts="rowwise"``,
                                              "int8_static" its
                                              ``int8_acts=<four scales>``)
                                              ops/pallas/trunk.py:128
                                              ``fused_window_trunk`` ("v1")
=====================  =====================  ===============================

The first TPU function has five kernel bodies (trunk2.py:51, :105, :255,
:335, :432) that tile the same arithmetic in five ways for the MXU; one CUDA
source answers for all of them, and for trunk.py's, at widths 128 (8 heads)
and 192 (12 heads), every mode on TMA and ``wgmma``, two windows a block
sharing every weight slab: the bf16 modes ("v2", "v1") from ``wpack``, the
int8 modes (C = 192) on int8 ``wgmma`` from ``wpack_i8`` / ``wpack_i8s``,
whose proj and fc2 rows arrive in the kernel's K order (``K_PERM``);
"int8_rowwise" computes fc1 twice, the first pass finding each row's
largest GELU output. The rounding points, with ``dt`` the activations' dtype
(bf16 on the card), are those of ``_trunk2_pair_kernel`` (trunk2.py:187-252)
and the plain versions have the same ones:

- every stacked parameter is cast to ``dt`` first, LayerNorm scales and
  shifts and all biases included; the relative-position bias stays f32;
- LayerNorm: f32 mean, var = E[x^2] - mean^2 (not clamped), eps 1e-5, the
  affine in f32, one rounding to ``dt``;
- qkv, proj, fc1, fc2: ``dt`` operands, f32 accumulation, rounded to ``dt``,
  then the bias added in ``dt`` (a second rounding);
- q * head_dim^-0.5 in ``dt``; scores f32 plus the f32 bias; softmax in f32
  per window and head; probabilities rounded to ``dt``; P.V accumulated in
  f32 and rounded to ``dt``;
- residual adds in ``dt``: x + (product + bias) in "v2" and
  "int8_rowwise", (x + product) + bias in "v1" (trunk.py:109, 114-115);
- GELU in f32 as 0.5 x (1 + erf(x / sqrt 2)), one rounding to ``dt``;
- "int8_rowwise" (trunk2.py:165-181): each GEMM input quantized per token
  row, the weights per output channel (``ops.quant``), the product
  int8 x int8 summed exactly, then (float(sum) * srow) * sw in f32;
- "int8_static" (trunk2.py:182-185, the static ``int8_gemms``): each GEMM
  input quantized per input channel with a calibrated scale, xq =
  clip(round(f32(x) * ia), -127, 127), the scale folded into the weights
  before they are quantized per output channel
  (``ops.quant.static_gemm_weights``), the product summed exactly, then
  float(sum) * sw in f32. The scales come from
  ``models.common.trunk_int8_scales``; ``chip_smoke.py``'s ``trunk_static``
  line runs the mode at full width, and ``JAX_PLATFORMS=cpu python -m
  pytest tests/test_torch_int8_static_trunk.py -q`` holds it against JAX.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel, adds one to ``LAUNCHES["fused_window_trunk"]`` and
to ``MODE_LAUNCHES[mode]``, and never falls back.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.kernels import _build
from transformerupscaler_torch.kernels._common import (
    LAUNCHES,
    MODE_LAUNCHES,
    TRUNK_MODES,
    check,
    on_card,
    raise_on,
    stream_of,
)
from transformerupscaler_torch.ops.quant import (
    quantize_rows,
    quantize_static,
    rowwise_weights,
    static_gemm_weights,
)
from transformerupscaler_torch.ops.relpos import gather_relative_bias

# What the CUDA kernel is compiled for: windows of 64 tokens, heads of 16,
# hidden 4 x dim; per width the modes it takes (by their index in
# TRUNK_MODES, which is the kernel's mode argument).
TOKENS, HEAD_DIM, SLAB_N = 64, 16, 64
TABLE = 225  # relative offsets of an 8 x 8 window
# The K order of the int8 modes' proj and fc2 weight rows: in each 16
# inputs, K slot 4t + e holds input 2t + e % 2 + 8 (e // 2), the order in
# which a thread's accumulator pairs and attention's context fragments fill
# an int8 wgmma A fragment (csrc/window_trunk.cu ``to_frags_i8``). An int8
# sum is exact in any order.
K_PERM = tuple(2 * (s // 4) + s % 2 + 8 * (s % 4 // 2) for s in range(16))
KERNEL_MODES = {128: ("v2", "v1"), 192: TRUNK_MODES}
GEMMS = ("qkvw", "projw", "fc1w", "fc2w")
EPS = 1e-5


def stack_trunk_params(blocks, dtype,
                       int8_rowwise: bool = False) -> dict[str, torch.Tensor]:
    """Stack the ``WindowBlock`` modules' parameters over layers, cast to
    ``dtype`` (JAX: the ``stack`` closure and the bias gather of
    trunk2.py:573-599).

    Returns (L = layers, C = dim, H = hidden): ``ln1s, ln1b, ln2s, ln2b,
    projb, fc2b`` (L, C); ``qkvb`` (L, 3C); ``fc1b`` (L, H); ``qkvw``
    (L, C, 3C), ``projw`` (L, C, C), ``fc1w`` (L, C, H), ``fc2w`` (L, H, C)
    as (in, out); ``bias`` (L, heads, n, n) f32; ``heads``. At the widths
    the CUDA kernel takes, also its two packed operands: ``wpack``
    (L, 12C/64, C, 64), each layer's GEMM weights cut into the slabs of
    C rows x 64 that the kernel streams by TMA, in the order it
    consumes them (``_pack_slabs``), ``vpack`` (L, 13C): ln1s, ln1b,
    qkvb, projb, ln2s, ln2b, fc1b, fc2b side by side, and ``tables``
    (L, heads, 225) f32, each head's relative-position table, which the
    kernel reads in every mode (the plain versions read ``bias``).

    ``int8_rowwise`` adds the rowwise mode's weights, quantized from the
    ``dtype`` values (``ops.quant.rowwise_weights``): ``<gemm>_q`` int8
    (in, out) and ``<gemm>_sw`` f32 (L, out) for each of the four GEMMs and,
    where the kernel takes the mode, ``wpack_i8`` (L, 16C/64, C, 64), the
    int8 weights as that mode's slabs (``_pack_slabs``), and ``swpack``
    (L, 9C), the four scales side by side. The
    static mode's weights depend on its scales: ``add_static_int8`` adds
    them to the stacked parameters.
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
    if int8_rowwise:
        for k in GEMMS:
            p[k + "_q"], p[k + "_sw"] = rowwise_weights(p[k])
    _, c, hidden = p["fc1w"].shape
    if (ws * ws, c // HEAD_DIM, hidden) == (TOKENS, p["heads"], 4 * c) \
            and c in KERNEL_MODES:
        p["wpack"] = _pack_slabs(p)
        p["vpack"] = torch.cat([p[k] for k in (
            "ln1s", "ln1b", "qkvb", "projb", "ln2s", "ln2b", "fc1b",
            "fc2b")], dim=1).contiguous()
        p["tables"] = torch.stack([b.attn.bias_table.float().t()
                                   for b in blocks]).contiguous()
        if int8_rowwise and "int8_rowwise" in KERNEL_MODES[c]:
            p["wpack_i8"] = _pack_slabs(p, "_q", fc1_twice=True)
            p["swpack"] = _side_by_side(p, "_sw")
    return p


def _pack_slabs(p, suffix="", fc1_twice=False):
    """The four GEMMs' weights ``<gemm><suffix>`` (L, in, out) as the
    kernel's slabs (L, n, C, 64), rows of 64 inputs, in the order it
    consumes them: per head group of 64 channels, the k, v and q output
    chunks of 64 (each C/64 tiles [64 outputs][64 inputs], the inputs in
    order), then proj's rows of those 64 inputs as [C outputs][64 inputs];
    per hidden chunk of 64, fc1's output chunk, then fc2's rows of those
    inputs: n = 12C/64. The int8 weights (a ``suffix``) give proj's and
    fc2's rows their inputs in ``K_PERM`` order within each 16. With
    ``fc1_twice`` ("int8_rowwise"), proj's rows follow every group's k, v,
    q chunks, and fc1's chunks stand once alone before the fc1 / fc2 pairs:
    n = 16C/64."""
    layers, c = p["qkvw"].shape[:2]
    order = _k_order(bool(suffix))

    def chunk(w, o0):  # outputs o0..o0+63 -> (L, C/64 x 64, 64)
        t = w[:, :, o0:o0 + 64].reshape(layers, c // 64, 64, 64)
        return t.transpose(2, 3).reshape(layers, c, 64)

    def rows(w, i0):  # inputs i0 + order -> (L, C, 64)
        return w[:, i0 + order.to(w.device), :].transpose(1, 2)

    qkv, proj, fc1, fc2 = (p[k + suffix] for k in GEMMS)
    qkv_g = [[chunk(qkv, c + i0), chunk(qkv, 2 * c + i0), chunk(qkv, i0)]
             for i0 in range(0, c, 64)]
    proj_g = [rows(proj, i0) for i0 in range(0, c, 64)]
    if fc1_twice:
        slabs = sum(qkv_g, []) + proj_g
        slabs += [chunk(fc1, i0) for i0 in range(0, 4 * c, 64)]
    else:
        slabs = sum((g + [r] for g, r in zip(qkv_g, proj_g)), [])
    for i0 in range(0, 4 * c, 64):
        slabs += [chunk(fc1, i0), rows(fc2, i0)]
    return torch.stack(slabs, dim=1).contiguous()


def _k_order(int8: bool) -> torch.Tensor:
    """The inputs of a 64-input slab of proj or fc2 rows in K order: in
    order, or for the int8 weights ``K_PERM`` within each 16."""
    order = torch.arange(64)
    return order // 16 * 16 + torch.tensor(K_PERM).repeat(4) if int8 \
        else order


def _side_by_side(p, suffix):
    return torch.cat([p[k + suffix] for k in GEMMS], dim=1).contiguous()


def add_static_int8(p: dict, scales) -> dict:
    """A copy of the stacked parameters ``p`` with the static mode's
    weights for the four per-input-channel activation scale stacks
    ``scales`` (s_qkv (L, C), s_proj (L, C), s_fc1 (L, C), s_fc2 (L, H);
    ``check_static_scales``), folded into the stacked weights and quantized
    (``ops.quant.static_gemm_weights``): ``<gemm>_sq`` int8 (in, out),
    ``<gemm>_ssw`` f32 (L, out) and ``<gemm>_ia`` f32 (L, in) and, where
    the kernel takes the mode, ``wpack_i8s`` (L, 12C/64, C, 64), the
    static int8 weights as that mode's slabs (``_pack_slabs``, in the bf16
    modes' order), ``swpack_s`` (L, 9C) and ``iapack``
    (L, 7C), the four inverse activation scales side by side; and
    ``int8_acts``, the ``scales`` object itself, by which
    ``models.common.run_window_trunk`` knows the pack was folded for it."""
    layers, c, hidden = p["fc1w"].shape
    p = dict(p, int8_acts=scales)
    for k, s_in in zip(GEMMS, check_static_scales(scales, layers, c,
                                                   hidden)):
        p[k + "_sq"], p[k + "_ssw"], p[k + "_ia"] = static_gemm_weights(
            p[k], s_in.to(p[k].device))
    if "wpack" in p and "int8_static" in KERNEL_MODES[c]:
        p["wpack_i8s"] = _pack_slabs(p, "_sq")
        p["swpack_s"] = _side_by_side(p, "_ssw")
        p["iapack"] = _side_by_side(p, "_ia")
    return p


def check_static_scales(scales, layers: int, dim: int, hidden: int):
    """The static mode's four activation scale stacks as f32 tensors of
    shapes (L, C), (L, C), (L, C), (L, H) (the JAX ``int8_acts`` tuple:
    qkv, proj, fc1 and fc2 inputs); raises ValueError naming what differs."""
    want = ((layers, dim), (layers, dim), (layers, dim), (layers, hidden))
    if isinstance(scales, (str, bytes)) or len(scales) != 4:
        raise ValueError(f"int8_acts: four per-channel scale stacks of "
                         f"shapes {want}, got {len(scales)} entries")
    out = tuple(torch.as_tensor(s, dtype=torch.float32) for s in scales)
    got = tuple(tuple(s.shape) for s in out)
    if got != want:
        raise ValueError(f"int8_acts: scale shapes {got}, expected {want}")
    return out


def _layernorm(x, scale, shift):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + EPS)
    return (y * scale.float() + shift.float()).to(x.dtype)


def _product(x, params, name, l, mode):
    """x @ W rounded to x's dtype, before the bias: the f32-accumulated
    product, or in the int8 modes (float(xq @ wq) * srow) * sw
    ("int8_rowwise") or float(xq @ wq) * sw ("int8_static"), the int8
    product summed exactly in float64."""
    if mode == "int8_rowwise":
        xq, srow = quantize_rows(x)
        acc = (xq.double() @ params[name + "_q"][l].double()).float()
        return (acc * srow * params[name + "_sw"][l]).to(x.dtype)
    if mode == "int8_static":
        xq = quantize_static(x, params[name + "_ia"][l])
        acc = (xq.double() @ params[name + "_sq"][l].double()).float()
        return (acc * params[name + "_ssw"][l]).to(x.dtype)
    return (x.float() @ params[name][l].float()).to(x.dtype)


def fused_window_trunk_plain(win: torch.Tensor, params: dict,
                             mode: str = "v2") -> torch.Tensor:
    """Plain version of ``fused_window_trunk``; any widths."""
    if mode not in TRUNK_MODES:
        raise ValueError(f"mode: one of {TRUNK_MODES}, got {mode!r}")
    nw, n, c = win.shape
    dt = win.dtype
    heads = params["heads"]
    hd = c // heads

    def residual(x, y, b):
        return (x + y) + b if mode == "v1" else x + (y + b)

    x = win
    for l in range(params["qkvw"].shape[0]):
        y = _layernorm(x, params["ln1s"][l], params["ln1b"][l])
        qkv = _product(y, params, "qkvw", l, mode) + params["qkvb"][l]
        q, k, v = (t.reshape(nw, n, heads, hd).transpose(1, 2)
                   for t in qkv.split(c, dim=-1))  # (nW, heads, n, hd)
        q = q * torch.tensor(hd ** -0.5, dtype=dt)
        s = q.float() @ k.float().transpose(-1, -2) + params["bias"][l]
        prob = torch.softmax(s, dim=-1).to(dt)
        ctx = (prob.float() @ v.float()).to(dt)
        ctx = ctx.transpose(1, 2).reshape(nw, n, c)
        x = residual(x, _product(ctx, params, "projw", l, mode),
                     params["projb"][l])
        y = _layernorm(x, params["ln2s"][l], params["ln2b"][l])
        hf = (_product(y, params, "fc1w", l, mode)
              + params["fc1b"][l]).float()
        hid = (0.5 * hf * (1.0 + torch.erf(hf * 2.0 ** -0.5))).to(dt)
        x = residual(x, _product(hid, params, "fc2w", l, mode),
                     params["fc2b"][l])
    return x


# Per kernel mode: its packed weights and, in the int8 modes, its packed
# weight scales and inverse activation scales.
PACKS = {"v2": ("wpack", None, None), "v1": ("wpack", None, None),
         "int8_rowwise": ("wpack_i8", "swpack", None),
         "int8_static": ("wpack_i8s", "swpack_s", "iapack")}


def fused_window_trunk(win: torch.Tensor, params: dict,
                       mode: str = "v2") -> torch.Tensor:
    """All window blocks on window tokens.

    win: (nW, 64, C) windows of 8x8 tokens; params: what
    ``stack_trunk_params(blocks, win.dtype, ...)`` returns, with the int8
    weights of the mode (``int8_rowwise=True``, or for "int8_static" passed
    through ``add_static_int8``);
    mode: "v2", "v1", "int8_rowwise" or "int8_static" (module docstring).
    The card takes C = 128 and 192 with heads of 16 and hidden 4C, the int8
    modes at C = 192; any number of layers and windows. Returns the same
    shape and dtype.
    """
    if mode not in TRUNK_MODES:
        raise ValueError(f"mode: one of {TRUNK_MODES}, got {mode!r}")
    tensors = [v for v in params.values() if isinstance(v, torch.Tensor)]
    if not on_card(win, *tensors):
        return fused_window_trunk_plain(win, params, mode)
    nw, _, c = win.shape
    wkey, skey, ikey = PACKS[mode]
    if wkey not in params or mode not in KERNEL_MODES.get(c, ()):
        raise ValueError(
            f"fused_window_trunk: the kernel takes {TOKENS} tokens, heads of "
            f"{HEAD_DIM}, hidden 4 x dim, in modes {KERNEL_MODES} by dim; got "
            f"dim {c}, fc1 {tuple(params['fc1w'].shape[1:])}, "
            f"{params['heads']} heads, mode {mode!r}"
            + ("" if wkey in params else f" without {wkey!r}"))
    layers = params["wpack"].shape[0]
    check(win, "win", torch.bfloat16, (nw, TOKENS, c))
    slabs = (12 + 4 * (mode == "int8_rowwise")) * c // SLAB_N
    check(params[wkey], wkey, torch.bfloat16 if skey is None else torch.int8,
          (layers, slabs, c, SLAB_N))
    check(params["vpack"], "vpack", torch.bfloat16, (layers, 13 * c))
    check(params["tables"], "tables", torch.float32,
          (layers, c // HEAD_DIM, TABLE))
    sw = ia = 0
    if skey is not None:
        check(params[skey], skey, torch.float32, (layers, 9 * c))
        sw = params[skey].data_ptr()
    if ikey is not None:
        check(params[ikey], ikey, torch.float32, (layers, 7 * c))
        ia = params[ikey].data_ptr()
    out = torch.empty_like(win)
    err = _build.load("window_trunk").tux_window_trunk(
        win.data_ptr(), params[wkey].data_ptr(), params["vpack"].data_ptr(),
        params["tables"].data_ptr(), sw, ia, out.data_ptr(), nw, layers, c,
        TRUNK_MODES.index(mode), win.device.index, stream_of(win))
    raise_on(err, "fused_window_trunk")
    LAUNCHES["fused_window_trunk"] += 1
    MODE_LAUNCHES[mode] += 1
    return out


def wgmma_i8_probe(a: torch.Tensor, b: torch.Tensor, a2: torch.Tensor,
                   w2: torch.Tensor):
    """The int8 modes' two ``wgmma`` products alone, as the kernel runs
    them (csrc/window_trunk.cu ``wgmma_i8_probe_kernel``): a, b (64, 192),
    a2 (64, 64) and w2 (64, 192) int8 on the card. Returns (a @ b.T,
    a2 @ w2) in int32: the first from 64B-swizzled TMA tiles as a qkv or
    fc1 chunk, the second with w2's rows packed as a proj or fc2 slab
    (``_k_order``) and a2 fed through the accumulator-to-fragment map."""
    for name, t, shape in (("a", a, (64, 192)), ("b", b, (64, 192)),
                           ("a2", a2, (64, 64)), ("w2", w2, (64, 192))):
        check(t, name, torch.int8, shape)
    b2 = w2[_k_order(True).to(w2.device)].t().contiguous()
    out1 = torch.empty(64, 64, dtype=torch.int32, device=a.device)
    out2 = torch.empty(64, 192, dtype=torch.int32, device=a.device)
    err = _build.load("window_trunk").tux_wgmma_i8_probe(
        a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
        out1.data_ptr(), out2.data_ptr(), a.device.index, stream_of(a))
    raise_on(err, "wgmma_i8_probe")
    return out1, out2


def gelu_i8_probe(d: torch.Tensor) -> torch.Tensor:
    """The int8 modes' GELU alone (csrc/window_trunk.cu ``gelu_i8``, as
    their epilogues round it): d (n,) bf16 on the card; returns
    bf16(gelu_i8(d))."""
    n = d.shape[0]
    check(d, "d", torch.bfloat16, (n,))
    out = torch.empty_like(d)
    err = _build.load("window_trunk").tux_gelu_i8_probe(
        d.data_ptr(), out.data_ptr(), n, d.device.index, stream_of(d))
    raise_on(err, "gelu_i8_probe")
    return out
