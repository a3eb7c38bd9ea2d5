"""The program's own per-frame spans in an open-loop stream cell: the cell's
pipeline and traffic, with the port's ``profiling.FrameTrace`` set on the
pipeline after the warm-up and before the window.

    python3 benchmark/frame_spans.py --workload fast_live_1080p_4k \\
        [--seed 7] [--seconds 51] [--profile 1]

One process, one run of the cell's traffic at its rate (pre-roll, then
``--seconds``), as ``benchmark/run.py`` runs it, without the comparison
with the reference. ``--profile 1`` runs the window as the traced run
does (the benchmark's patching wrappers, a ``torch.profiler`` slice of its
last 2 s) and reads the frames of the part before the slice; ``--profile
0`` has neither and reads the whole window.

Standard error gives the program's counters over the run, the anchor's
drift and checks, and each frame's chained segments (``frames.CHAIN``) with
the time they leave unaccounted (its latency less their sum: median and
maximum). The last line of standard output is one JSON object: the means a
frame of ``frames.READINGS`` (``held_ms``, ``dispatch_ms``,
``copy_out_ms``, ``device_ms``), the median latency, the counters, and with
``--profile 1`` the slice's busy time and idle gaps. The result goes into
``PERF.md``.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from benchmark.lib import device, spec  # noqa: E402
from benchmark.lib.frames import (  # noqa: E402
    CHAIN,
    READINGS,
    chain_ms,
    mean_ms,
)
from benchmark.lib.stream import (  # noqa: E402
    OpenSource,
    Recorder,
    build_pipeline,
    make_frames,
)
from benchmark.lib.weights import load_flat  # noqa: E402


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def anchor_log(trace, part):
    """The anchor's drift over the run and where it puts the card's events
    against the host spans around them."""
    drift = [(t, d * 1e6) for t, d in trace.drift]
    if drift:
        log(f"anchor drift: {len(drift)} probes over {drift[-1][0]:.1f} s, "
            f"last {drift[-1][1]:+.1f} us, largest "
            f"{max(abs(d) for _, d in drift):.1f} us; re-anchored "
            f"{trace.reanchored} times")
    start = min(r.times["device.copy_in"][0] - r.times["pipeline.enqueue"][0]
                for r in part)
    end = min(r.times["pipeline.fetch_wait"][1]
              - r.times["device.copy_out"][1] for r in part)
    log(f"anchor check: device.copy_in starts at least {start * 1e6:.1f} us "
        f"after pipeline.enqueue does; pipeline.fetch_wait ends at least "
        f"{end * 1e6:.1f} us after device.copy_out")
    return drift


def chain_log(part, source: OpenSource, arrivals: list) -> dict:
    """Each frame's chained segments and the time they leave unaccounted."""
    chains = [chain_ms(r.times, source.due(r.n), arrivals[r.n])
              for r in part if r.n < len(arrivals)]
    un = [c["unaccounted"] for c in chains]
    med = {k: statistics.median(c[k] for c in chains) for k in CHAIN}
    log("frame segments, median ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in med.items())
        + f"; unaccounted median {statistics.median(un):.4f}, max "
        f"{max(un):.4f}, min {min(un):.4f} over {len(un)} frames")
    return dict(segments_ms=med, unaccounted_ms=dict(
        median=statistics.median(un), max=max(un), min=min(un)))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = p.parse_args()
    cell = spec.Cell(spec.benchmark_spec(), args.workload)
    traffic = cell.traffic
    if "rate_hz" not in traffic:
        raise SystemExit(f"{args.workload}: not an open-loop cell")
    dev = device.require_cards(cell.chips)
    log(f"card: {device.power_limit()}")
    frames = make_frames(args.seed, traffic["res_in"], traffic["ring"], dev)
    pipe = build_pipeline(cell.config, traffic, load_flat(cell.config), dev)
    pipe.warmup()

    from transformerupscaler_torch import profiling

    rec = Recorder(pipe, args.seconds, 0, args.seed, bool(args.profile))
    source = OpenSource(frames, rec, traffic["rate_hz"], traffic["preroll_s"])
    trace = profiling.FrameTrace(source.last + 64)
    counters0 = dict(profiling.COUNTERS)
    pipe.trace = trace
    pipe.run(source, sink=rec)
    rec.finish()
    pipe.trace = None

    counters = {k: v - counters0[k] for k, v in profiling.COUNTERS.items()}
    done = max(len(trace.frames), 1)
    part = [r for r in trace.frames
            if r.n >= source.first and source.due(r.n) < rec.t_part]
    late = [r for r in part if r.n >= source.first + 3]
    log("program counters over the run (pre-roll, window, the frames after "
        "it): " + ", ".join(f"{k} {v}" for k, v in counters.items())
        + f"; bytes a frame in {counters['bytes_in'] / done:.0f}, out "
        f"{counters['bytes_out'] / done:.0f}; new_frame_arrays after the "
        f"window's first three frames {sum(r.new_array for r in late)}")
    spans = {"frame_spans": [dict(r.times) for r in part]}
    out = {"workload": args.workload, "seed": args.seed,
           "profile": args.profile, "frames": len(part),
           **{k: mean_ms(spans, f) for k, f in READINGS.items()},
           "frame_ms_p50": float(np.median(
               source.latencies_ms(part_only=True))),
           "counters": counters}
    if part and "device.copy_in" in part[0].times:
        drift = anchor_log(trace, part)
        out["anchor_drift_us"] = max((abs(d) for _, d in drift), default=None)
        out.update(chain_log(part, source, rec.arrivals))
    if rec.slice is not None and rec.slice.events:
        summary = rec.slice.reduce()
        out.update(busy_s=summary.busy_s, window_s=summary.window_s,
                   idle_gaps=summary.idle_gaps())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
