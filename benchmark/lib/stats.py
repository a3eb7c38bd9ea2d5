"""Statistics and the card's published peaks."""

from __future__ import annotations

import math

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def nearest_rank(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest
    value with at least q% of the values at or below it. A value may be
    ``inf`` (a frame never delivered)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
