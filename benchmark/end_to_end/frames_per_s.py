"""Frames handed to the sink in the window, over the window's seconds
(closed loop)."""


def read(rec: dict) -> float | None:
    return rec.get("frames_per_s") or None
