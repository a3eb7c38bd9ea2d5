"""``fetch_wait_ms`` in the open-loop cells, where it moves
``frame_ms_p95``: the host's time blocked in the pipeline's fetch, a frame
(``fetch_wait_ms.py``); the fetch of each frame lies on its way to the
sink."""

from benchmark.layer_metrics.fetch_wait_ms import read  # noqa: F401
