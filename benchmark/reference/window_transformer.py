"""WindowTransformer in plain PyTorch: the published model
(WindowTransformer/model.py:187-197 of the reference repository; dim 128,
8 blocks, 8 heads, window 8, 8x8 patches, a stride-2 downsample).

x (N, 3, H, W) in [0, 1] ->
  feat = relu(conv2(relu(conv1(x))))                      64 channels
  down = downsample(feat) (3x3, stride 2, padding 1, no relu)
  tokens = patch embed (8x8, stride 8) of down, floored to whole patches
  tokens = window blocks (windows of 8x8 tokens, grid zero-padded)
  combined = down + patch unembed, both cropped to their common extent
  residual = decoder_conv2(relu(decoder_conv1(combined)))  (64 -> 3)
  out = bicubic(x, res_out) + bicubic(residual, res_out), clipped to [0, 1]
  (bicubic: ``F.interpolate(mode="bicubic", align_corners=False)``).

Departures from the published model: none.
"""

from __future__ import annotations

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


def _bicubic(x, res_out):
    return F.interpolate(x, size=tuple(res_out), mode="bicubic",
                         align_corners=False)


def forward(p: dict, x: torch.Tensor, res_out, cfg: dict,
            precision: str = "f32") -> torch.Tensor:
    """p: {JAX path: float32 tensor}; x: (N, 3, H, W) float32 in [0, 1];
    cfg: the config file's ``fields``. Returns (N, 3, res_out) float32."""
    ps = cfg["patch_size"]
    x = rnd(x, precision)
    feat = conv(x, p, "conv1", relu=True, precision=precision)
    feat = conv(feat, p, "conv2", relu=True, precision=precision)
    down = conv(feat, p, "downsample", stride=2, precision=precision)
    hd, wd = down.shape[2:]
    ht, wt = hd // ps, wd // ps
    tokens = patch_embed(down[:, :, :ht * ps, :wt * ps],
                         p["patch_embed_kernel"], p["patch_embed_bias"],
                         precision)
    tokens = window_trunk(tokens, p, cfg["num_window_blocks"],
                          cfg["num_heads"], cfg["window_size"], precision)
    trans = patch_unembed(tokens, p["patch_unembed_kernel"],
                          p["patch_unembed_bias"], precision)
    mh, mw = min(hd, trans.shape[2]), min(wd, trans.shape[3])
    combined = rnd(down[:, :, :mh, :mw] + trans[:, :, :mh, :mw], precision)
    dec = conv(combined, p, "decoder_conv1", relu=True, precision=precision)
    res = conv(dec, p, "decoder_conv2", precision=precision)
    out = rnd(rnd(_bicubic(x, res_out), precision)
              + rnd(_bicubic(res, res_out), precision), precision)
    return out.clamp(0.0, 1.0)


def _down_hw(h: int, w: int) -> tuple[int, int]:
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def token_grid(h: int, w: int, cfg: dict) -> tuple[int, int]:
    """The trunk's token grid of an h x w frame."""
    hd, wd = _down_hw(h, w)
    return hd // cfg["patch_size"], wd // cfg["patch_size"]


def flops(h: int, w: int, res_out, cfg: dict) -> float:
    """Operations (2 per multiply-add) of one frame of the published model
    at these shapes: the convs, the downsample, the patch products, the
    trunk over its padded window grid, the two bicubic resizes (4 taps a
    pass)."""
    c, d, ps = cfg["base_channels"], cfg["transformer_dim"], cfg["patch_size"]
    ws = cfg["window_size"]
    hd, wd = _down_hw(h, w)
    ht, wt = token_grid(h, w, cfg)
    total = conv_flops(h, w, 3, 3, c) + conv_flops(h, w, 3, c, c)
    total += conv_flops(hd, wd, 3, c, c)
    total += 2 * 2.0 * ht * wt * ps * ps * c * d
    total += trunk_flops(padded_windows(ht, wt, ws) * ws * ws, d,
                         cfg["num_window_blocks"], ws)
    mh, mw = min(hd, ht * ps), min(wd, wt * ps)
    total += conv_flops(mh, mw, 3, c, c) + conv_flops(mh, mw, 3, c, 3)
    total += resize_flops((h, w), tuple(res_out), 3, 4.0)
    total += resize_flops((mh, mw), tuple(res_out), 3, 4.0)
    return total


def kernel_shapes(h: int, w: int, res_out, cfg: dict) -> dict:
    """The work one frame gives the port's kernels that a roofline reads:
    conv2 (3x3 64 -> 64 at base resolution) and the trunk's padded window
    grid."""
    c = cfg["base_channels"]
    ht, wt = token_grid(h, w, cfg)
    ws = cfg["window_size"]
    return {
        "conv3x3": [(h, w, c, c)],
        "trunk": [(padded_windows(ht, wt, ws), ws * ws, cfg["transformer_dim"],
                   cfg["num_window_blocks"], cfg["num_heads"])],
    }
