"""The knee of an open-loop stream cell: the highest rate the pipeline
sustains without a growing backlog, found by a sweep on the card.

    python3 benchmark/sweep.py --workload fast_live_1080p_4k \\
        --rates 120,150,180,200,220,240 [--seconds 4] [--seed 7]

One process, one pipeline: for each rate the cell's own traffic at that
rate for ``--seconds``, then one line a rate: the frames a second the sink
received over the window's frames, the backlog (frames due by the window's
end and not yet at the sink then), the median latency of the window's last
quarter less that of its first (growing when the pipeline falls behind),
the 50th and 95th percentile latencies. The cell's rate is written into
the traffic file by hand, below the highest rate with no backlog by as
much as the host's slow minutes take from it, and the sweep into
``PERF.md``.
"""

import argparse
import json
import sys
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


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()
    cell = spec.Cell(spec.benchmark_spec(), args.workload)
    dev = device.require_cards(cell.chips)
    print(f"card: {device.power_limit()}", file=sys.stderr)
    traffic = cell.traffic
    frames = make_frames(args.seed, traffic["res_in"], traffic["ring"],
                         dev)
    pipe = build_pipeline(cell.config, traffic, load_flat(cell.config), dev)
    pipe.warmup()
    for rate in (float(r) for r in args.rates.split(",")):
        rec = Recorder(pipe, args.seconds, 0, args.seed, False)
        src = OpenSource(frames, rec, rate, traffic["preroll_s"])
        pipe.run(src, sink=rec)
        lat = np.array(src.latencies_ms())
        n = len(lat)
        t_end = src.due(src.last + 1)
        arrived = sum(1 for j in range(src.first, src.last + 1)
                      if j < len(rec.arrivals) and rec.arrivals[j] <= t_end)
        first = [rec.arrivals[j] for j in (src.first, src.last)]
        q = max(n // 4, 1)
        print(json.dumps({
            "rate_hz": rate, "frames": n,
            "delivered_per_s": (n - 1) / (first[1] - first[0]),
            "backlog_frames": n - arrived,
            "latency_growth_ms": float(np.median(lat[-q:])
                                       - np.median(lat[:q])),
            "p50_ms": nearest_rank(lat, 50), "p95_ms": nearest_rank(lat, 95),
            "max_ms": float(lat.max())}), flush=True)


if __name__ == "__main__":
    main()
