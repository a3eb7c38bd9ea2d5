"""The fused window trunk's share of its roofline (``rooflines/trunk.py``)
in the traced slice."""

from benchmark.lib.roofline import share


def read(rec: dict) -> float | None:
    return share(rec, "trunk")
