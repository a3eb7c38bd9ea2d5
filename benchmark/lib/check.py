"""What decides ``correct``: the frames the timed path delivered, against
the plain reference run on the same source frames and the same weights.

The reference's float32 output is quantized as the stream step quantizes
its own, trunc(clip(out * 255 + 0.5, 0, 255)), flipped to BGR where the
traffic asks, and each delivered frame is compared with it value by value
in levels of 255, leaving out a ring of ``compare_border_px`` at the border
where the config says the served route differs by design. The numbers
(``NUMBERS``) are each taken as the worst over the sampled frames; each has
the limit the config's ``limits`` gives it.
"""

from __future__ import annotations

import numpy as np

# The numbers of one comparison: the mean |difference| in levels, the
# shares of values off by more than 1, 2, 4 and 8 levels, the largest.
SHARES = (1, 2, 4, 8)
NUMBERS = ("mean_abs", *(f"share_over_{k}" for k in SHARES), "max_abs")


def reference_u8(ref, cfg: dict, traffic: dict, p: dict, frame: np.ndarray,
                 device, precision: str = "f32"):
    """The reference's frame for one source frame: HWC float32 tensor of
    whole levels on ``device``."""
    import torch

    from benchmark.reference.common import strict_f32

    x = torch.from_numpy(frame).to(device).permute(2, 0, 1)[None]
    x = x.to(torch.float32) / 255.0
    with strict_f32(), torch.no_grad():
        y = ref.forward(p, x, tuple(traffic["res_out"]), cfg["fields"],
                        precision)
    u8 = torch.floor((y[0] * 255.0 + 0.5).clamp(0.0, 255.0)).permute(1, 2, 0)
    return u8.flip(-1) if traffic.get("bgr_out") else u8


def frame_numbers(got: np.ndarray, want, border: int) -> dict:
    """The numbers of one delivered frame (HWC uint8) against the
    reference's (HWC whole levels)."""
    import torch

    g = torch.from_numpy(np.ascontiguousarray(got)).to(want.device)
    d = (g.to(torch.float32) - want).abs()
    if border:
        d = d[border:-border, border:-border]
    out = {"mean_abs": d.mean().item(), "max_abs": d.max().item()}
    for k in SHARES:
        out[f"share_over_{k}"] = (d > k).to(torch.float32).mean().item()
    return out


def worst(per_frame: list[dict]) -> dict:
    return {n: max(f[n] for f in per_frame) for n in NUMBERS}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number at or under its limit, {name: {"value",
    "limit"}} for each limited number)."""
    shown = {n: {"value": numbers[n], "limit": lim}
             for n, lim in limits.items()}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown


def compare_stream(ref, cfg: dict, traffic: dict, flat: dict, frames,
                   kept, device, precision: str = "f32") -> dict:
    """Compare the kept frames [(source index, HWC uint8)] with the
    reference on their source frames (each source frame run once)."""
    from benchmark.reference.common import to_device

    p = to_device(flat, device)
    cache: dict = {}
    per_frame = []
    for k, got in kept:
        i = k % len(frames)
        if i not in cache:
            cache[i] = reference_u8(ref, cfg, traffic, p, frames[i], device,
                                    precision)
        per_frame.append(frame_numbers(got, cache[i],
                                       cfg.get("compare_border_px", 0)))
    if not per_frame:
        return {"correct": False, "frames": 0, "shown": {},
                "why": "no frame was delivered in the window"}
    numbers = worst(per_frame)
    ok, shown = judge(numbers, cfg["limits"])
    return {"correct": ok, "frames": len(per_frame), "numbers": numbers,
            "shown": shown}
