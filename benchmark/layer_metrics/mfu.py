"""The whole step's share of the card's bf16 peak: the published model's
operations a frame (the config's reference ``flops``, whatever computes
them) times the frames a second the traced run delivered in its window."""

from benchmark.lib.stats import PEAK_BF16_FLOPS


def read(rec: dict) -> float | None:
    if not rec.get("flops_per_frame") or not rec.get("frames_per_s"):
        return None
    return 100.0 * rec["flops_per_frame"] * rec["frames_per_s"] \
        / PEAK_BF16_FLOPS
