"""Host time blocked in the pipeline's fetch (``StreamPipeline._fetch``:
waiting for the frame's copy out, then copying it out of its pinned slot),
a frame: the program's own "postprocess" stage total over the window's
frames."""


def read(rec: dict) -> float | None:
    if not rec.get("frames") or "fetch_wait_s" not in rec:
        return None
    return rec["fetch_wait_s"] / rec["frames"] * 1e3
