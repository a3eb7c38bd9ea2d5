"""Model lookup by name (JAX counterpart: transformerupscaler_tpu
registry.py:38).

The port serves one route so far: FastTransformer with composed tails, the
stream kernels, the folded branch-B tail and the plain PyTorch trunk, i.e.
the JAX configuration ``compose_tails=True, pallas_serve=True,
split_tail=False, attn_impl="xla"``. Asking for another route raises.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.models.fast_transformer import FastTransformer

_MODELS = {"FastTransformer": FastTransformer}
SLICE_ROUTE = {"compose_tails": True, "pallas_serve": True,
               "split_tail": False, "attn_impl": "xla"}


def list_models() -> list[str]:
    return sorted(_MODELS)


def get_model(name: str, device=None, dtype=torch.float32, **config):
    """Build model ``name`` on ``device`` (default: the card).

    ``config`` takes the model's constructor fields and the JAX serving
    route flags of ``SLICE_ROUTE``; route flags must name that route.
    """
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    for key, want in SLICE_ROUTE.items():
        if key in config and config.pop(key) != want:
            raise NotImplementedError(
                f"{key}={want!r} is the only route the port serves so far")
    dev = resolve_device(device)
    return _MODELS[name](dtype=dtype, **config).to(dev)
