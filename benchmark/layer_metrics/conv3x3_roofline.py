"""The stream 3x3 conv's share of its roofline (``rooflines/conv3x3.py``),
summed over a frame's launches, in the traced slice."""

from benchmark.lib.roofline import share


def read(rec: dict) -> float | None:
    return share(rec, "conv3x3")
