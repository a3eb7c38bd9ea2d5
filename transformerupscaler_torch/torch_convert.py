"""PyTorch ``state_dict`` -> JAX-layout parameter tree: the port's own copy
of transformerupscaler_tpu/tools/torch_convert.py (the port imports nothing
of the JAX package), so that a legacy ``model_epoch_{n}.pth`` checkpoint
(reference train.py:152-156) loads into ``weights.params_from_jax``:

  - Conv2d (O, I, kh, kw)           -> HWIO kernel, transpose (2, 3, 1, 0)
  - ConvTranspose2d (I, O, kh, kw)  -> (I, kh, kw, O), transpose (0, 2, 3, 1)
  - Linear (out, in)                -> (in, out), transpose
  - LayerNorm weight/bias           -> scale/bias
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(sd, t, bias=True):
    out = {"kernel": np.transpose(np.asarray(sd[f"{t}.weight"]), (2, 3, 1, 0))}
    if bias:
        out["bias"] = np.asarray(sd[f"{t}.bias"])
    return out


def _norm(sd, t):
    return {"scale": np.asarray(sd[f"{t}.weight"]), "bias": np.asarray(sd[f"{t}.bias"])}


def _dense(sd, t):
    return {"kernel": np.asarray(sd[f"{t}.weight"]).T,
            "bias": np.asarray(sd[f"{t}.bias"])}


def _window_block(sd, t):
    return {
        "norm1": _norm(sd, f"{t}.norm1"),
        "norm2": _norm(sd, f"{t}.norm2"),
        "attn": {
            "qkv_kernel": np.asarray(sd[f"{t}.attn.qkv.weight"]).T,
            "qkv_bias": np.asarray(sd[f"{t}.attn.qkv.bias"]),
            "proj_kernel": np.asarray(sd[f"{t}.attn.proj.weight"]).T,
            "proj_bias": np.asarray(sd[f"{t}.attn.proj.bias"]),
            "bias_table": np.asarray(sd[f"{t}.attn.relative_position_bias_table"]),
        },
        "mlp_fc1": _dense(sd, f"{t}.mlp.0"),
        "mlp_fc2": _dense(sd, f"{t}.mlp.2"),
    }


def _global_block(sd, t):
    return {
        "norm1": _norm(sd, f"{t}.norm1"),
        "norm2": _norm(sd, f"{t}.norm2"),
        "in_kernel": np.asarray(sd[f"{t}.attn.in_proj_weight"]).T,
        "in_bias": np.asarray(sd[f"{t}.attn.in_proj_bias"]),
        "out_kernel": np.asarray(sd[f"{t}.attn.out_proj.weight"]).T,
        "out_bias": np.asarray(sd[f"{t}.attn.out_proj.bias"]),
        "mlp_fc1": _dense(sd, f"{t}.mlp.0"),
        "mlp_fc2": _dense(sd, f"{t}.mlp.2"),
    }


def _patch_pair(sd):
    return {
        "patch_embed_kernel": np.transpose(np.asarray(sd["patch_embed.weight"]), (2, 3, 1, 0)),
        "patch_embed_bias": np.asarray(sd["patch_embed.bias"]),
        "patch_unembed_kernel": np.transpose(np.asarray(sd["patch_unembed.weight"]), (0, 2, 3, 1)),
        "patch_unembed_bias": np.asarray(sd["patch_unembed.bias"]),
    }


# torch Sequential index of the i-th conv inside an Upsampler branch
# (reference models/FastTransformer/utils.py:57-91): scale 4 has two
# conv+shuffle stages, the rest one.
_UPS_IDX = {2: [0], 3: [0], 4: [0, 2], 6: [0]}


def _upsampler(sd, t):
    out = {}
    for scale, idxs in _UPS_IDX.items():
        for i, idx in enumerate(idxs):
            w = np.asarray(sd[f"{t}.upsamplers.{scale}.{idx}.weight"])
            out[f"s{scale}_c{i}_kernel"] = np.transpose(w, (2, 3, 1, 0))
            out[f"s{scale}_c{i}_bias"] = np.asarray(sd[f"{t}.upsamplers.{scale}.{idx}.bias"])
    return out


def _n_blocks(sd, prefix):
    n = 0
    while f"{prefix}.{n}.norm1.weight" in sd:
        n += 1
    return n


def convert_state_dict(state_dict, model_name: str) -> dict:
    """Return {'params': tree} matching this package's flax modules."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}

    if model_name == "BicubicInterpolation":
        return {"params": {}}

    p: dict = {}
    if model_name == "WindowTransformer":
        p["conv1"] = _conv(sd, "conv1")
        p["conv2"] = _conv(sd, "conv2")
        p["downsample"] = _conv(sd, "downsample")
        p.update(_patch_pair(sd))
        for i in range(_n_blocks(sd, "window_blocks")):
            p[f"blocks_{i}"] = _window_block(sd, f"window_blocks.{i}")
        p["decoder_conv1"] = _conv(sd, "decoder_conv1")
        p["decoder_conv2"] = _conv(sd, "decoder_conv2")
    elif model_name == "FastTransformer":
        p["conv1"] = _conv(sd, "conv1")
        p["conv2"] = _conv(sd, "conv2")
        p["up1"] = _upsampler(sd, "up1")
        p["up1_conv_kernel"] = np.transpose(
            np.asarray(sd["up1_conv.conv.weight"]), (2, 3, 1, 0))
        p["final_upscale"] = _upsampler(sd, "final_upscale")
        p["final_upscale_conv_kernel"] = np.transpose(
            np.asarray(sd["final_upscale_conv.weight"]), (2, 3, 1, 0))
        p["final_upscale_conv_bias"] = np.asarray(sd["final_upscale_conv.bias"])
        p.update(_patch_pair(sd))
        for i in range(_n_blocks(sd, "window_blocks")):
            p[f"blocks_{i}"] = _window_block(sd, f"window_blocks.{i}")
        p["decoder_conv1"] = _conv(sd, "decoder_conv1")
        p["decoder_conv2"] = _conv(sd, "decoder_conv2")
    elif model_name == "ResidualTransformer":
        p["conv1"] = _conv(sd, "conv1")
        p["conv2"] = _conv(sd, "conv2")
        p["downsample"] = _conv(sd, "downsample")
        p.update(_patch_pair(sd))
        p["pos_embed"] = np.asarray(sd["pos_embed"])
        for i in range(_n_blocks(sd, "transformer_blocks")):
            p[f"blocks_{i}"] = _global_block(sd, f"transformer_blocks.{i}")
        p["decoder_conv1"] = _conv(sd, "decoder_conv1")
        p["decoder_conv2"] = _conv(sd, "decoder_conv2")
    else:
        raise ValueError(f"No converter for model {model_name!r}")

    return {"params": p}


def load_pth(path: str, model_name: str) -> dict:
    """Load a .pth checkpoint file (tensors only) and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(sd, model_name)
