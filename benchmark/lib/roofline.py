"""A kernel's share of its roofline in the traced slice: the least time
its launches could take on the card, over their device time.

The least time of one launch is the larger of its operations at the bf16
peak and its bytes at the memory rate (each input byte read once, each
output byte written once), from ``rooflines/<kernel>.py`` at the shapes the
config's reference gives for one frame (``kernel_shapes``). Where the trace
shows another number of launches a frame than those shapes, the route has
changed and the share is not read.
"""

from __future__ import annotations

from benchmark.lib.spec import load_module
from benchmark.lib.stats import PEAK_BF16_FLOPS, PEAK_BYTES


def least_seconds(flops: float, n_bytes: float) -> float:
    """The larger of the operations at the bf16 peak and the bytes at the
    memory rate (``chip_smoke.bound_ms``'s arithmetic)."""
    return max(flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES)


def share(rec: dict, kernel: str) -> float | None:
    """Percent of the roofline, or None where there is nothing to read."""
    summary = rec.get("trace")
    shapes = rec.get("kernel_shapes", {}).get(kernel)
    frames = rec.get("trace_frames", 0)
    if summary is None or not shapes or frames <= 0:
        return None
    mod = load_module("rooflines", kernel)
    launches, seconds = summary.kernels(mod.PATTERN)
    if launches == 0 or seconds <= 0:
        return None
    # The slice may cut a frame at each end; more than that off is a route
    # that launches the kernel another number of times a frame.
    per_frame = launches / frames
    if abs(per_frame - len(shapes)) > 2.0 * len(shapes) / frames + 0.05:
        return None
    least = launches / len(shapes) * sum(least_seconds(*mod.work(s))
                                         for s in shapes)
    return 100.0 * least / seconds
