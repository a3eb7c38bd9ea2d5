"""The program's own per-frame spans, as ``benchmark/frame_spans.py`` reads
them from a cell's pipeline.

With the port's ``profiling.FrameTrace`` set on the pipeline, each frame
gives one dict: span name -> (start, end), seconds on
``time.perf_counter``, the clock of the source's due times and the sink's
arrivals. The device intervals (``device.*``) are the frame's own CUDA
events placed on that clock by the program's anchor. ``READINGS`` are the
per-frame quantities a frame's spans give; ``mean_ms`` takes their mean
over a record's ``frame_spans``, None where there are none (a program
without the trace) or they lack a span a reading needs.
"""

from __future__ import annotations

import statistics

# A frame's way from its due time to the sink, in order. Each segment is
# read from the frame's spans; what they leave out of the latency is the
# frame's unaccounted time.
CHAIN = ("source lateness", "preprocess", "held", "dispatch",
         "device after dispatch", "fetch wait", "copy out", "sink")


def span_ms(frame: dict, name: str) -> float:
    start, end = frame[name]
    return (end - start) * 1e3


def held_ms(frame: dict) -> float:
    """Time the frame sits in the pipeline with no work on it: from its
    preprocess's end to its dispatch, and from its copy out's end on the
    card (or its dispatch's end, where the host was still dispatching) to
    its fetch (none where the fetch had to wait)."""
    worked = max(frame["device.copy_out"][1], frame["pipeline.dispatch"][1])
    return 1e3 * (frame["pipeline.dispatch"][0]
                  - frame["pipeline.preprocess"][1]
                  + max(0.0, frame["pipeline.fetch"][0] - worked))


def device_ms(frame: dict) -> float:
    """The frame's device time: its copy in's start to its copy out's
    end."""
    return 1e3 * (frame["device.copy_out"][1] - frame["device.copy_in"][0])


# name -> ms a frame: the schedule's cost, the dispatch (slot wait, staging
# copy, enqueues), the host copy out of the pinned slot without the wait,
# and the card's time from the copy in's start to the copy out's end.
READINGS = {
    "held_ms": held_ms,
    "dispatch_ms": lambda f: span_ms(f, "pipeline.dispatch"),
    "copy_out_ms": lambda f: span_ms(f, "pipeline.copy_out"),
    "device_ms": device_ms,
}


def mean_ms(rec: dict, per_frame) -> float | None:
    """The mean of ``per_frame(frame)`` over the record's frames; None where
    there are none or they lack a span it reads."""
    frames = rec.get("frame_spans")
    if not frames:
        return None
    try:
        return statistics.fmean(per_frame(f) for f in frames)
    except KeyError:
        return None


def chain_ms(frame: dict, due: float, arrival: float) -> dict[str, float]:
    """The segments of ``CHAIN`` for a frame due at ``due`` that reached the
    sink at ``arrival``, in ms, and its ``unaccounted`` time: the latency
    less their sum. The preprocess segment runs from the pull's end
    through the hand-off to the worker; the device's time after the
    dispatch ends where the fetch starts (a fetch that waits counts the
    rest as its wait)."""
    pull, pre = frame["pipeline.pull"], frame["pipeline.preprocess"]
    disp, fetch = frame["pipeline.dispatch"], frame["pipeline.fetch"]
    dev_end = frame["device.copy_out"][1]
    seg = {"source lateness": pull[1] - due,
           "preprocess": pre[1] - pull[1],
           "held": held_ms(frame) * 1e-3,
           "dispatch": disp[1] - disp[0],
           "device after dispatch": max(0.0, min(dev_end, fetch[0])
                                        - disp[1]),
           "fetch wait": span_ms(frame, "pipeline.fetch_wait") * 1e-3,
           "copy out": span_ms(frame, "pipeline.copy_out") * 1e-3,
           "sink": arrival - frame["pipeline.sink"][0]}
    out = {k: v * 1e3 for k, v in seg.items()}
    out["unaccounted"] = (arrival - due) * 1e3 - sum(out.values())
    return out
