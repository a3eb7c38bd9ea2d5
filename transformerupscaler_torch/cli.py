"""What the port's command lines share: the serving flags that ``--fast``,
``--quality``, ``--int8`` and ``--int8_trunk`` select, and image files on
a host without PIL.

The JAX command lines (inference.py:80-99, speed_test.py:30-48,
stream.py:47-59, app_overlay.py:101-114) choose the Pallas stream kernels
and the fused trunk for ``--fast`` on a TPU only, and JAX's all-XLA packed
path elsewhere; the "tails" int8 scope needs the stream kernels anywhere.
``serve_flags`` applies that rule with the card in the TPU's place.
"""

from __future__ import annotations

import torch

from transformerupscaler_torch.png import read_png, write_png


def on_card(device) -> bool:
    """Whether a command line's ``--device`` (None: the card) is a GPU."""
    return torch.device(device or "cuda").type == "cuda"


def serve_flags(fast: bool, quality: bool, int8: str = "off",
                int8_trunk: bool = False, card: bool = True) -> dict:
    """The engine's serving flags for ``--fast``, ``--quality`` (a mode of
    ``--fast``), ``--int8 <scope>`` and ``--int8_trunk``; ``card``: the
    engine runs on the card."""
    fast = fast or quality
    pallas = (fast and card) or int8 == "tails"
    return dict(int8_serve=int8 != "off",
                int8_scope=int8 if int8 != "off" else "full",
                compose_tails=fast or int8 != "off",
                packed_serve=fast, pallas_serve=pallas,
                serve_quality=quality,
                attn_impl="fused2" if (pallas and card) or int8_trunk
                else "xla")


def card_dtype(dtype, flags: dict, card: bool):
    """The compute dtype of an engine with ``flags``: bf16 where the card's
    stream kernels serve, which take bf16 only (said on stdout), else
    ``dtype``."""
    if card and flags["pallas_serve"] and dtype == torch.float32:
        print("the stream kernels on the card take bf16; using bf16 compute")
        return torch.bfloat16
    return dtype


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, "cpu" for the CPU."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def require_png(path: str, use: str) -> None:
    """Raise unless ``path`` names a PNG file; a JPEG one raises naming the
    missing codec (``use``: "decoder" or "encoder")."""
    if str(path).lower().endswith((".jpg", ".jpeg")):
        raise ValueError(
            f"{path}: the port has no JPEG {use} (its host has no PIL); use "
            f"a .png path")
    if not str(path).lower().endswith(".png"):
        raise ValueError(f"{path}: the port reads and writes .png files only")


def read_image(path: str):
    """A PNG file as (H, W, 3) uint8 RGB."""
    require_png(path, "decoder")
    return read_png(path)


def write_image(path: str, hwc_uint8) -> None:
    """(H, W, 3) uint8 RGB to a PNG file."""
    require_png(path, "encoder")
    write_png(path, hwc_uint8)
