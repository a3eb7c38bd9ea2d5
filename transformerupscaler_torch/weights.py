"""Carry parameters between the JAX package's layout and the port's modules,
and initialise them as the JAX models do.

A JAX parameter tree is the nested dict of numpy arrays that flax ``init``
and ``checkpoint.load_checkpoint`` produce (HWIO conv kernels, (in, out)
dense kernels). The port's modules keep the same leaves under the same
names, with ``blocks_<i>`` as ``blocks.<i>``, so the mapping is by name.
The port's Adam state is ``{"mu": tree, "nu": tree, "count": int}``, the
moments of optax's ``ScaleByAdamState`` as trees of the same paths
(``opt_state_from_jax`` converts one).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn


def jax_path(name: str) -> str:
    """Port parameter name -> JAX tree path ("blocks.0.attn.qkv_kernel" ->
    "blocks_0/attn/qkv_kernel")."""
    return re.sub(r"^blocks\.(\d+)\.", r"blocks_\1.", name).replace(".", "/")


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": v}} -> {"a/b": v} (the inverse of ``unflatten``)."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def unflatten(flat: dict) -> dict:
    """{"a/b/c": v} -> {"a": {"b": {"c": v}}}."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def params_from_jax(model: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX parameter tree (optionally wrapped as {"params": ...})
    into ``model``; its leaves may be numpy arrays or tensors. Raises
    ValueError naming every missing or leftover leaf and every shape
    mismatch. Returns the model."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten(tree)
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
            v = flat[path]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, np.float32))
            p.copy_(v)
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


def params_to_jax(model: nn.Module) -> dict:
    """``model``'s parameters as a JAX tree of float32 numpy arrays on the
    host, copies (the inverse of ``params_from_jax``)."""
    return unflatten({jax_path(n): np.array(p.detach().float().cpu())
                      for n, p in model.named_parameters()})


# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance-scaling initialisers divide by it (jax.nn.initializers).
TRUNCATED_UNIT_STD = 0.87962566103423978


def init_params(model: nn.Module, seed: int, device=None) -> dict:
    """Fresh parameters for ``model`` as the JAX models initialise them,
    drawn in sorted path order from ``torch.Generator(device)`` seeded with
    ``seed``; a JAX tree of float32 tensors on ``device`` (default: where
    the model's parameters are). Every kernel is flax's ``lecun_normal``:
    truncated normal at +-2 sigma with sigma = sqrt(1 / fan_in) /
    TRUNCATED_UNIT_STD, fan_in the product of all but the last axis (flax's
    in_axis -2, out_axis -1; ResidualTransformer's ``nn.Dense`` layers
    default to the same); biases zero; LayerNorm scales one; the relative
    position tables ``truncated_normal(0.02)`` (at +-0.04);
    ResidualTransformer's ``pos_embed`` ``normal(1.0)``. The values are not
    JAX's (another generator); their distributions are."""
    named = dict(model.named_parameters())
    dev = torch.device(device) if device is not None else (
        next(iter(named.values())).device)
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {jax_path(n): tuple(p.shape) for n, p in named.items()}
    flat = {}
    for path in sorted(shapes):
        shape = shapes[path]
        leaf = path.rsplit("/", 1)[-1]
        v = torch.empty(shape, device=dev)
        if leaf.endswith("bias"):
            v.zero_()
        elif leaf == "scale":
            v.fill_(1.0)
        elif leaf == "pos_embed":
            v.normal_(generator=g)
        elif leaf == "bias_table":
            nn.init.trunc_normal_(v, std=0.02, a=-0.04, b=0.04, generator=g)
        elif leaf.endswith("kernel"):
            std = (1.0 / np.prod(shape[:-1])) ** 0.5 / TRUNCATED_UNIT_STD
            nn.init.trunc_normal_(v, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
        else:
            raise ValueError(f"no JAX initialiser for leaf {path}")
        flat[path] = v
    return unflatten(flat)


def opt_state_from_jax(optax_state) -> dict:
    """optax ``adam``'s state (``(ScaleByAdamState(count, mu, nu),
    EmptyState())``, or the ``ScaleByAdamState`` alone) -> the port's Adam
    state {"mu": tree, "nu": tree, "count": int} of float32 numpy arrays,
    so that a run of the JAX package resumes in the port."""
    states = optax_state if isinstance(optax_state, (tuple, list)) else (
        optax_state,)
    adam = [s for s in states if all(hasattr(s, k)
                                     for k in ("mu", "nu", "count"))]
    if len(adam) != 1:
        raise ValueError("not an optax adam state: no single "
                         "ScaleByAdamState(count, mu, nu) in it")
    adam = adam[0]

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, Mapping)
                else np.asarray(v, np.float32) for k, v in tree.items()}

    return {"mu": to_numpy(adam.mu), "nu": to_numpy(adam.nu),
            "count": int(np.asarray(adam.count))}
