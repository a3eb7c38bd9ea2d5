"""The share of the window's part (before the profiled slice) in which no
frame's work ran on the card: one minus the frames' device time over the
part's seconds. A frame's device time is its copy in (the profiled
slice's mean "Memcpy HtoD") plus the span from its graph replay's start
to the end of its copy out, by the CUDA events the traced run records
(``lib/stream.py``). It is read outside the slice, because the profiler
slows the host that paces these cells; a launch gap inside a frame counts
as busy."""


def read(rec: dict) -> float | None:
    spans, t = rec.get("frame_device_ms"), rec.get("trace")
    if not spans or t is None or not rec.get("part_s"):
        return None
    copies, seconds = t.kernels("HtoD", "gpu_memcpy")
    if not copies:
        return None
    busy_ms = sum(spans) + len(spans) * seconds / copies * 1e3
    return 100.0 * (1.0 - busy_ms / (rec["part_s"] * 1e3))
