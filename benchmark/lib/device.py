"""The card a run measures, and the checks every run makes on its process."""

from __future__ import annotations

import subprocess
import sys

# Top-level module names no process of the benchmark may hold: the JAX
# package beside the port and what it runs on.
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "transformerupscaler_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot),
    compared whole, is one of ``FORBIDDEN``. The port's name begins with
    the JAX package's, so a prefix test would be wrong."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def require_cards(n: int):
    """Exit with an error unless ``n`` CUDA cards are visible; returns the
    first. Nothing falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: the benchmark measures "
                         "the port on the card and prints no result")
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, {have} visible")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.replace("\n", "; ")


def device_record(count: int) -> dict:
    """The result's ``device``: platform, the card's name, the cards used,
    the peak of allocated memory on the fullest."""
    import torch

    peaks = [torch.cuda.max_memory_allocated(i) for i in range(count)]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(max(peaks))}
