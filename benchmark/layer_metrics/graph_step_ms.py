"""The device time of one graph replay of the stream step (normalize, the
model, flip, clip, cast: ``infer_lib.CapturedForward.replay``), by CUDA
events the benchmark records around each replay of the window in the
traced run; the window's mean."""


def read(rec: dict) -> float | None:
    ms = rec.get("graph_ms")
    return sum(ms) / len(ms) if ms else None
