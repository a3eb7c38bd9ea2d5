"""Model lookup by name (JAX counterpart: transformerupscaler_tpu
registry.py:38).

The port serves FastTransformer with composed tails on the stream kernels
(JAX ``compose_tails=True, pallas_serve=True``), with the trunk fused
(``attn_impl="fused2"``) or in plain PyTorch (``"xla"``) and the branch-B
tail split, folded or chosen by dtype (``split_tail`` True, False, None).
Asking for another route raises.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.models.common import TRUNK_IMPLS
from transformerupscaler_torch.models.fast_transformer import FastTransformer

_MODELS = {"FastTransformer": FastTransformer}
# JAX route flags that are not fields of the port's model, with the one value
# the port serves.
FIXED_ROUTE = {"compose_tails": True, "pallas_serve": True}


def list_models() -> list[str]:
    return sorted(_MODELS)


def get_model(name: str, device=None, dtype=torch.float32, **config):
    """Build model ``name`` on ``device`` (default: the card).

    ``config`` takes the model's constructor fields (``attn_impl``,
    ``split_tail`` and ``hi_lo_fin`` among them) and the JAX serving route
    flags of ``FIXED_ROUTE``; a route the port does not serve raises
    ``NotImplementedError``.
    """
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    for key, want in FIXED_ROUTE.items():
        if config.pop(key, want) != want:
            raise NotImplementedError(f"the port serves {key}={want!r} only")
    if config.get("attn_impl", "xla") not in TRUNK_IMPLS:
        raise NotImplementedError(
            f"attn_impl={config['attn_impl']!r}: the port serves attn_impl "
            f"in {TRUNK_IMPLS}")
    dev = resolve_device(device)
    return _MODELS[name](dtype=dtype, **config).to(dev)
