"""Model lookup by name (JAX counterpart: transformerupscaler_tpu
registry.py).

``register_model(name, description)`` decorates a factory (a class or a
function taking the model's fields as keywords and returning a
``torch.nn.Module``) and enters it as a ``ModelEntry``, as JAX's does;
``get_model``, ``list_models``, the engine and the command lines'
``--model`` then find it. The port registers the four models of the JAX
package:

- ``FastTransformer``: the exact path (JAX ``__call__``, the default
  fields, ``compose_tails`` and ``fix_ratio_bug`` either way), and its
  serving forward at x2, x3, x4 and x6: on the stream kernels
  (``compose_tails=True, pallas_serve=True``) or JAX's all-XLA packed path
  (``packed_serve`` or ``int8_serve`` without ``pallas_serve``), the trunk
  fused (``attn_impl="fused2"``, with ``int8_trunk`` its GEMMs in int8, or
  ``"fused"``), block by block in PyTorch (``"xla"``) or block by block
  around the window-attention kernel (``"pallas"``), the branch-B tail
  split, folded or chosen by dtype (``split_tail`` True, False, None), or
  factored (``fold_pre=False``); with ``int8_serve`` in the scopes "full",
  "residual" and "tails" (``int8_scope``), with dynamic or static
  (``int8_scales``) scales; conv1 on its kernel (``conv1_stream``);
  ``serve_quality`` with ``quality_parts``, ``f32_tail`` and ``hi_lo_fin``;
  ``int8_mlp``, and the offline GPTQ weights ``int8_weights``;
- ``WindowTransformer``: the exact path, ``pallas_serve``, ``int8_mlp`` and
  ``attn_impl`` "xla", "pallas", "fused" or "fused2";
- ``ResidualTransformer``: the exact path, ``packed_serve``, ``pallas_serve``
  and any ``attn_impl`` ("xla" is the eager attention, every other value the
  ``global_mha`` kernel, as in the JAX model);
- ``BicubicInterpolation``, which has no fields.

Asking for an ``attn_impl`` the port does not serve raises
``NotImplementedError``. Like the JAX ``get_model``, fields a model does
not have are dropped, so that one set of serving flags can go to every
model: the flags the JAX command lines pass with ``--fast``
(inference.py:83-98, speed_test.py:35-48) serve all four.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable

import torch

from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.models.bicubic import BicubicInterpolation
from transformerupscaler_torch.models.common import TRUNK_IMPLS
from transformerupscaler_torch.models.fast_transformer import FastTransformer
from transformerupscaler_torch.models.residual_transformer import (
    ResidualTransformer,
)
from transformerupscaler_torch.models.window_transformer import (
    WindowTransformer,
)


@dataclass(frozen=True)
class ModelEntry:
    name: str
    factory: Callable  # (**fields) -> torch.nn.Module
    description: str = ""


_REGISTRY: dict[str, ModelEntry] = {}


def register_model(name: str, description: str = ""):
    """Decorator: enter ``factory`` under ``name`` (a later registration
    of the name replaces it) and return it unchanged."""
    def wrap(factory):
        _REGISTRY[name] = ModelEntry(name=name, factory=factory,
                                     description=description)
        return factory
    return wrap


for _cls, _what in (
        (BicubicInterpolation, "parameterless bicubic baseline"),
        (FastTransformer, "flagship: learned pixel-shuffle SR, 6.45M params"),
        (ResidualTransformer, "global-attention SR, fixed 720p, 3.21M "
                              "params"),
        (WindowTransformer, "Swin-style window-attention SR, 2.76M params")):
    register_model(_cls.__name__, _what)(_cls)

# Per model: the ``attn_impl`` values the port serves (a model not named
# takes any).
ATTN_IMPLS = {"FastTransformer": TRUNK_IMPLS, "WindowTransformer": TRUNK_IMPLS}
# JAX fields that a model without them drops, so that one set of flags can
# go to every model (the serving flags are FastTransformer's; the bicubic
# baseline has no ``dropout``).
IGNORED = ("dropout", "compose_tails", "packed_serve", "pallas_serve",
           "int8_mlp", "int8_serve", "int8_scope", "int8_scales",
           "int8_trunk", "serve_quality", "attn_impl", "split_tail",
           "hi_lo_fin", "fix_ratio_bug", "int8_weights", "quality_parts",
           "f32_tail", "fold_pre", "conv1_stream")


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def _fields(factory) -> set[str] | None:
    """The keyword fields ``factory`` takes; None if it takes any."""
    params = inspect.signature(factory).parameters.values()
    if any(p.kind is p.VAR_KEYWORD for p in params):
        return None
    return {p.name for p in params}


def get_model(name: str, device=None, dtype=torch.float32, **config):
    """Build model ``name`` on ``device`` (default: the card).

    ``config`` takes the model's constructor fields and the JAX serving route
    flags; an ``attn_impl`` the port does not serve raises
    ``NotImplementedError``.
    """
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    impls = ATTN_IMPLS.get(name)
    if impls is not None and config.get("attn_impl", "xla") not in impls:
        raise NotImplementedError(
            f"attn_impl={config['attn_impl']!r}: the port serves {name} "
            f"with attn_impl in {impls}")
    dev = resolve_device(device)
    factory = _REGISTRY[name].factory
    fields = _fields(factory)
    if fields is not None:
        config = {k: v for k, v in config.items()
                  if k in fields or k not in IGNORED}
    if fields is None or "dtype" in fields:
        config["dtype"] = dtype
    return factory(**config).to(dev)
