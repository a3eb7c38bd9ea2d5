"""The port's counters, counted where the work happens whether or not a
trace is set: the bytes the stream pipeline copies in and out
(``stream_lib``), output arrays it had to allocate (``new_frame_arrays``),
frames it retired with no next frame waiting (``frames_retired_alone``) and
after the next frame's dispatch (``frames_retired_behind``), CUDA graphs
captured (``infer_lib.CapturedForward``) and kernel libraries compiled
(``kernels._build.build_all``). ``profiling`` re-exports them.
"""

COUNTERS = dict.fromkeys(("bytes_in", "bytes_out", "new_frame_arrays",
                          "frames_retired_alone", "frames_retired_behind",
                          "graph_captures", "kernel_builds"), 0)
