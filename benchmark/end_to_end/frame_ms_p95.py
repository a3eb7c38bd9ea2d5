"""The 95th percentile (nearest rank) of the latencies of every frame due
in the window, from its due time to the sink, in ms; a frame that never
arrived counts its time until the run ended (and fails the run)."""

from benchmark.lib.stats import nearest_rank


def read(rec: dict) -> float | None:
    lat = rec.get("latencies_ms")
    return nearest_rank(lat, 95) if lat else None
