"""What the program's per-frame spans cost in an open-loop stream cell: the
cell's own pipeline and traffic, with ``pipe.trace`` set and cleared in
turn within one run.

    python3 benchmark/tracing_cost.py --workload fast_live_1080p_4k \\
        [--seconds 51] [--block 30] [--seed 7]

One process, one pipeline, one run of the cell's traffic at its rate
(pre-roll, then ``--seconds``). The source toggles the trace every
``--block`` frames, untraced and traced blocks in the order off, on, on,
off, off, on, ... so that each pair of neighbouring blocks is one
comparison and a drift of the host's speed cancels. The trace is a
``profiling.FrameTrace``; nothing else is traced (no profiler, none of the
benchmark's wrappers). A block's host time a frame is its wall time less
the time spent in the source (its sleep until a frame is due), over its
frames: the pipeline's own work on the host, traced or not. Three frames
are in flight, so a block shares two frames' work with its neighbour, and
the difference reads about ``2 / block`` low.

Prints one line a pair (untraced and traced host ms a frame) and a last
line: the median of the pairs' differences (traced less untraced), the
quartiles of the differences, and the window's 50th and 95th percentile
latencies of traced and untraced frames. The result goes into
``PERF.md``.
"""

import argparse
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from benchmark.lib import device, spec  # noqa: E402
from benchmark.lib.stats import nearest_rank  # noqa: E402
from benchmark.lib.stream import (  # noqa: E402
    OpenSource,
    Recorder,
    build_pipeline,
    make_frames,
)
from benchmark.lib.weights import load_flat  # noqa: E402


def traced_block(b: int) -> bool:
    """Blocks off, on, on, off, off, on, ...: pair k is blocks 2k, 2k+1."""
    return (b + 1) // 2 % 2 == 1


def toggling(src, pipe, frame_trace, block: int, marks: list):
    """``src``'s frames, with ``pipe.trace`` set for the traced blocks from
    each block's first frame on; ``marks`` gets (frame index, the host
    clock after the frame left the source, the seconds spent in the source
    so far) at each block's first frame."""
    in_source, it = 0.0, iter(src)
    for j in itertools.count():
        t0 = time.perf_counter()
        frame = next(it, None)
        t1 = time.perf_counter()
        if frame is None:
            return
        in_source += t1 - t0
        if j % block == 0:
            marks.append((j, t1, in_source))
            pipe.trace = frame_trace if traced_block(j // block) else None
        yield frame


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--block", type=int, default=30)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()
    cell = spec.Cell(spec.benchmark_spec(), args.workload)
    dev = device.require_cards(cell.chips)
    print(f"card: {device.power_limit()}", file=sys.stderr)
    traffic = cell.traffic
    frames = make_frames(args.seed, traffic["res_in"], traffic["ring"], dev)
    pipe = build_pipeline(cell.config, traffic, load_flat(cell.config), dev)
    pipe.warmup()

    from transformerupscaler_torch import profiling

    rec = Recorder(pipe, args.seconds, 0, args.seed, False)
    src = OpenSource(frames, rec, traffic["rate_hz"], traffic["preroll_s"])
    frame_trace = profiling.FrameTrace(src.last + 8)
    pipe.trace = frame_trace  # anchors the card's clock before the run
    pipe.trace = None
    marks: list = []
    pipe.run(toggling(src, pipe, frame_trace, args.block, marks), sink=rec)
    pipe.trace = None

    host = {}  # block -> host ms a frame, the window's whole blocks
    for (j, t, s), (j1, t1, s1) in zip(marks, marks[1:]):
        if j >= src.first and j1 <= src.last + 1:
            host[j // args.block] = ((t1 - t) - (s1 - s)) / (j1 - j) * 1e3
    diffs = []
    for k in range(max(host, default=0) // 2 + 1):
        on, off = (2 * k, 2 * k + 1) if traced_block(2 * k) else (
            2 * k + 1, 2 * k)
        if off in host and on in host:
            diffs.append(host[on] - host[off])
            print(json.dumps({"workload": args.workload, "pair": k,
                              "untraced_ms": host[off],
                              "traced_ms": host[on]}), flush=True)
    traced = {r.n for r in frame_trace.frames}
    lat = {True: [], False: []}
    for j, ms in zip(range(src.first, src.last + 1), src.latencies_ms()):
        lat[j in traced].append(ms)
    q = statistics.quantiles(diffs, n=4)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "pairs": len(diffs),
        "block": args.block,
        "host_ms_a_frame": {
            "untraced": statistics.median(
                v for b, v in host.items() if not traced_block(b)),
            "traced": statistics.median(
                v for b, v in host.items() if traced_block(b)),
            "difference": statistics.median(diffs),
            "difference_quartiles": [q[0], q[2]]},
        **{f"p{pct}_ms": {k: nearest_rank(np.array(lat[on]), pct)
                          for k, on in (("untraced", False),
                                        ("traced", True))}
           for pct in (50, 95)}}), flush=True)


if __name__ == "__main__":
    main()
