"""The median of the open-loop frames' latencies, due time to sink: the
steady part of the latency beside ``frame_ms_p95``'s tail; in the traced
run, of the frames due before the profiled slice."""

from benchmark.lib.stats import nearest_rank


def read(rec: dict) -> float | None:
    lat = rec.get("part_latencies_ms") or rec.get("latencies_ms")
    return nearest_rank(lat, 50) if lat else None
