"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one. ``None`` and ``"cuda"`` raise when no GPU is visible;
    tests pass ``device="cpu"``, where every kernel runs its plain version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; transformerupscaler_torch runs on the "
            "GPU unless the caller passes device='cpu'")
    return dev
