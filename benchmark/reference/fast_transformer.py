"""FastTransformer in plain PyTorch: the published model
(FastTransformer/model.py:189-199 of the reference repository; dim 192,
6 blocks, 12 heads, window 8, 8x8 patches, 64-channel encoder).

x (N, 3, H, W) in [0, 1] ->
  feat = relu(conv2(relu(conv1(x))))                      64 channels
  branch A: upsampler(feat) (3x3 conv to 64 s^2, pixel shuffle s, per
            stage), then a 3x3 conv 64 -> 3 without bias, relu
  tokens = patch embed (8x8, stride 8) of feat, reflect-padded at the
           bottom and right to a multiple of 8
  tokens = window blocks (windows of 8x8 tokens, grid zero-padded)
  combined = feat + patch unembed (transposed 8x8, stride 8), cropped
  branch B: decoder_conv2(relu(decoder_conv1(combined))) (64 -> 3), the
            3-channel upsampler, then a 3x3 conv 3 -> 3 with bias
  out = A + B at s x, the scale s = ceil(max(res_out / (H, W))); resized
        to res_out (bilinear, antialiased) when res_out differs from
        (sH, sH) and from (sH, sW) (the model's own test), clipped to
        [0, 1].

Departures from the published model: none in the arithmetic. The code under
test serves a composition of branch A's and B's convs at base resolution,
which zero-pads the input where the published model zero-pads each
intermediate map, so the two differ in a ring at the border by design: the
config file's ``compare_border_px`` leaves that ring out of the
comparison.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import (
    conv,
    conv_flops,
    padded_windows,
    patch_embed,
    patch_unembed,
    resize_flops,
    rnd,
    trunk_flops,
    window_trunk,
)

# scale -> (channel multiplier, shuffle factor) of each upsampler stage
STAGES = {2: [(4, 2)], 3: [(9, 3)], 4: [(4, 2), (4, 2)], 6: [(36, 6)]}


def geometry(h: int, w: int, res_out) -> tuple[int, bool]:
    """(scale, whether the output is resized to ``res_out``)."""
    s = math.ceil(max(res_out[0] / h, res_out[1] / w))
    oh, ow = h * s, w * s
    squash = tuple(res_out) != (oh, oh) and tuple(res_out) != (oh, ow)
    return s, squash


def _upsample(x, p, prefix, s, precision):
    for i, (_, r) in enumerate(STAGES[s]):
        x = F.pixel_shuffle(conv(x, p, f"{prefix}/s{s}_c{i}",
                                 precision=precision), r)
    return x


def forward(p: dict, x: torch.Tensor, res_out, cfg: dict,
            precision: str = "f32") -> torch.Tensor:
    """p: {JAX path: float32 tensor}; x: (N, 3, H, W) float32 in [0, 1];
    cfg: the config file's ``fields``. Returns (N, 3, res_out) float32."""
    ps, ws = cfg["patch_size"], cfg["window_size"]
    h, w = x.shape[2:]
    s, squash = geometry(h, w, res_out)
    x = rnd(x, precision)
    feat = conv(x, p, "conv1", relu=True, precision=precision)
    feat = conv(feat, p, "conv2", relu=True, precision=precision)
    up = _upsample(feat, p, "up1", s, precision)
    up = conv(up, p, "up1_conv", relu=True, bias=False, precision=precision)
    pad_h, pad_w = (ps - h % ps) % ps, (ps - w % ps) % ps
    feat_pad = F.pad(feat, (0, pad_w, 0, pad_h), mode="reflect")
    tokens = patch_embed(feat_pad, p["patch_embed_kernel"],
                         p["patch_embed_bias"], precision)
    tokens = window_trunk(tokens, p, cfg["num_window_blocks"],
                          cfg["num_heads"], ws, precision)
    trans = patch_unembed(tokens, p["patch_unembed_kernel"],
                          p["patch_unembed_bias"], precision)
    combined = rnd(feat + trans[:, :, :h, :w], precision)
    dec = conv(combined, p, "decoder_conv1", relu=True, precision=precision)
    res = conv(dec, p, "decoder_conv2", precision=precision)
    res = _upsample(res, p, "final_upscale", s, precision)
    res = conv(res, p, "final_upscale_conv", precision=precision)
    out = rnd(up + res, precision)
    if squash:
        out = rnd(F.interpolate(out, size=tuple(res_out), mode="bilinear",
                                align_corners=False, antialias=True),
                  precision)
    return out.clamp(0.0, 1.0)


def token_grid(h: int, w: int, cfg: dict) -> tuple[int, int]:
    """The trunk's token grid of an h x w frame (the features reflect-padded
    to whole patches)."""
    ps = cfg["patch_size"]
    return math.ceil(h / ps), math.ceil(w / ps)


def flops(h: int, w: int, res_out, cfg: dict) -> float:
    """Operations (2 per multiply-add) of one frame of the published model
    at these shapes, whatever computes them: the convs, the upsamplers and
    their tail convs, the patch products, the trunk over its padded window
    grid, the bilinear resize (2 taps a pass, widened by the downscale)."""
    c, d, ps = cfg["base_channels"], cfg["transformer_dim"], cfg["patch_size"]
    ws = cfg["window_size"]
    s, squash = geometry(h, w, res_out)
    ht, wt = token_grid(h, w, cfg)
    total = conv_flops(h, w, 3, 3, c) + conv_flops(h, w, 3, c, c)
    for n_feats, tail_out in ((c, 3), (3, 3)):
        hh, ww = h, w
        for mult, r in STAGES[s]:
            total += conv_flops(hh, ww, 3, n_feats, mult * n_feats)
            hh, ww = hh * r, ww * r
        total += conv_flops(hh, ww, 3, n_feats, tail_out)
    total += 2 * 2.0 * ht * wt * ps * ps * c * d  # embed and unembed
    total += trunk_flops(padded_windows(ht, wt, ws) * ws * ws, d,
                         cfg["num_window_blocks"], ws)
    total += conv_flops(h, w, 3, c, c) + conv_flops(h, w, 3, c, 3)
    if squash:
        total += resize_flops((h * s, w * s), tuple(res_out), 3, 2.0)
    return total


def kernel_shapes(h: int, w: int, res_out, cfg: dict) -> dict:
    """The work one frame gives the port's kernels that a roofline reads:
    the 3x3 64 -> 64 convs at base resolution (conv2 and decoder_conv1),
    and the trunk's padded window grid."""
    c = cfg["base_channels"]
    ht, wt = token_grid(h, w, cfg)
    ws = cfg["window_size"]
    return {
        "conv3x3": [(h, w, c, c), (h, w, c, c)],
        "trunk": [(padded_windows(ht, wt, ws), ws * ws, cfg["transformer_dim"],
                   cfg["num_window_blocks"], cfg["num_heads"])],
    }
