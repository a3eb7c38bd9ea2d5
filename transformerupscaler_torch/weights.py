"""Carry parameters between the JAX package's layout and the port's modules.

A JAX parameter tree is the nested dict of numpy arrays that flax ``init``
and ``checkpoint.load_checkpoint`` produce (HWIO conv kernels, (in, out)
dense kernels). The port's modules keep the same leaves under the same
names, with ``blocks_<i>`` as ``blocks.<i>``, so the mapping is by name.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn


def jax_path(name: str) -> str:
    """Port parameter name -> JAX tree path ("blocks.0.attn.qkv_kernel" ->
    "blocks_0/attn/qkv_kernel")."""
    return re.sub(r"^blocks\.(\d+)\.", r"blocks_\1.", name).replace(".", "/")


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def params_from_jax(model: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX parameter tree (optionally wrapped as {"params": ...})
    into ``model``. Raises ValueError naming every missing or leftover leaf
    and every shape mismatch. Returns the model."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    params = {jax_path(n): p for n, p in model.named_parameters()}
    missing = sorted(set(params) - set(flat))
    leftover = sorted(set(flat) - set(params))
    bad = sorted(p for p in set(params) & set(flat)
                 if tuple(np.shape(flat[p])) != tuple(params[p].shape))
    if missing or leftover or bad:
        raise ValueError(f"parameter tree does not fit the model: missing "
                         f"{missing}, leftover {leftover}, shape mismatch {bad}")
    with torch.no_grad():
        for path, p in params.items():
            p.copy_(torch.as_tensor(np.asarray(flat[path], np.float32)))
    if hasattr(model, "clear_derived"):
        model.clear_derived()
    return model


# Model class name -> {JAX path: factor on the leaf's seeded values}.
SMALL_LEAVES = {name: {"decoder_conv2/kernel": 0.1} for name in (
    "FastTransformer", "WindowTransformer", "ResidualTransformer")}


def seeded_params(model: nn.Module, seed: int) -> dict:
    """Random parameters for ``model`` as a JAX tree of float32 numpy arrays,
    drawn from ``numpy.random.default_rng(seed)`` in sorted path order, so the
    same seed gives the same tree wherever numpy runs. Kernels are normal
    with std 1/sqrt(fan_in), biases and the LayerNorm shift normal with std
    0.1, LayerNorm scales 1 + 0.1 normal, relative-bias tables normal with
    std 0.5, ``pos_embed`` normal with std 1.0 (as the JAX model initialises
    it). Biases are non-zero so that a mis-threaded bias shows. The leaves of
    ``SMALL_LEAVES`` are drawn smaller: each model's last decoder conv 10x,
    so that its output stays a small residual beside the other branch
    (FastTransformer's branch A, the bicubic upscale of the input in the
    other two), as in a trained model, instead of reaching magnitudes where
    one bf16 rounding step is several hundredths."""
    small = SMALL_LEAVES.get(type(model).__name__, {})
    rng = np.random.default_rng(seed)
    shapes = {jax_path(n): tuple(p.shape) for n, p in model.named_parameters()}
    tree: dict = {}
    for path in sorted(shapes):
        shape = shapes[path]
        leaf = path.rsplit("/", 1)[-1]
        z = rng.standard_normal(shape).astype(np.float32)
        if leaf == "bias_table":
            v = 0.5 * z
        elif leaf == "scale":
            v = 1.0 + 0.1 * z
        elif leaf.endswith("bias"):
            v = 0.1 * z
        elif leaf == "pos_embed":
            v = z
        else:
            fan_in = shape[0] if leaf == "patch_unembed_kernel" else int(
                np.prod(shape[:-1]))
            v = z / np.sqrt(fan_in)
            if path in small:
                v = small[path] * v
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = v.astype(np.float32)
    return tree
