"""``device_idle`` in the open-loop cells, where it moves ``frame_ms_p95``:
the share of the window's part in which no frame's work ran on the card
(``device_idle.py``)."""

from benchmark.layer_metrics.device_idle import read  # noqa: F401
