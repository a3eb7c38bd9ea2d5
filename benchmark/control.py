"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/control.py --workload fast_live_720p_1080p \\
        --seeds 12 [--first 1000] [--seconds 1.5] \\
        [--kinds program,int8,ref_fp8,ref_int8]

For each seed, the cell's own traffic and load for a short window through
``StreamPipeline.run``, and the kept frames compared with the plain
reference as a run compares them (``benchmark/lib/check.py``):

- ``program``: the port as the cell runs it, the lower readings;
- ``int8``: the port's own int8 serving path switched on (``--int8 full``
  with the cell's serving flags: every 3x3 and tail conv int8, dynamic
  scales), the control where the config serves a model that has one;
- ``ref_fp8``: the reference computed in fp8 (``reference/common.py``)
  in the program's place, the control otherwise;
- ``ref_int8``: the reference computed in int8 in the program's place,
  a reading beside the control.

Prints one JSON line per kind and seed with every number of
``check.NUMBERS``, then the largest (program) and smallest (controls)
reading of each number over the seeds. The runs of ``run.py`` never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import check, device, spec  # noqa: E402
from benchmark.lib.stream import (  # noqa: E402
    OpenSource,
    Recorder,
    build_pipeline,
    closed_source,
    make_frames,
)
from benchmark.lib.weights import load_flat  # noqa: E402


def pipeline_readings(cell, flat, dev, seeds, seconds, flags=None):
    """Numbers of the pipeline (with ``flags``) for each seed."""
    cfg, traffic = cell.config, cell.traffic
    pipe = build_pipeline(cfg, traffic, flat, dev, flags)
    pipe.warmup()
    ref = cell.reference()
    out = []
    for seed in seeds:
        frames = make_frames(seed, traffic["res_in"], traffic["ring"], dev)
        open_loop = "rate_hz" in traffic
        rec = Recorder(pipe, seconds, traffic["check_frames"], seed, False,
                       None if open_loop else traffic["preroll_frames"])
        source = (OpenSource(frames, rec, traffic["rate_hz"],
                             traffic["preroll_s"]) if open_loop
                  else closed_source(frames, rec))
        pipe.run(source, sink=rec)
        kept = rec.kept
        del rec, source
        res = check.compare_stream(ref, dict(cfg, limits={}), traffic, flat,
                                   frames, kept, dev)
        out.append((seed, res["numbers"]))
    return out


def ref_readings(cell, flat, dev, seeds, precision="fp8"):
    """Numbers of the reference in ``precision`` against the reference in
    float32, on ``check_frames`` source frames of each seed."""
    import torch

    from benchmark.reference.common import to_device

    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference()
    p = to_device(flat, dev)
    out = []
    for seed in seeds:
        frames = make_frames(seed, traffic["res_in"], traffic["ring"], dev)
        per = []
        for i in range(min(traffic["check_frames"], len(frames))):
            want = check.reference_u8(ref, cfg, traffic, p, frames[i], dev)
            got = check.reference_u8(ref, cfg, traffic, p, frames[i], dev,
                                     precision)
            got = got.to(torch.uint8).cpu().numpy()
            per.append(check.frame_numbers(got, want,
                                           cfg.get("compare_border_px", 0)))
        out.append((seed, check.worst(per)))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=1000)
    p.add_argument("--seconds", type=float, default=1.5)
    p.add_argument("--kinds", default="program,int8,ref_fp8,ref_int8")
    args = p.parse_args()
    cell = spec.Cell(spec.benchmark_spec(), args.workload)
    dev = device.require_cards(cell.chips)
    print(f"card: {device.power_limit()}", file=sys.stderr)
    flat = load_flat(cell.config)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    summary = {}
    for kind in args.kinds.split(","):
        t0 = time.perf_counter()
        if kind == "program":
            rows = pipeline_readings(cell, flat, dev, seeds, args.seconds)
        elif kind == "int8":
            rows = pipeline_readings(cell, flat, dev, seeds, args.seconds,
                                     {"int8": "full"})
        elif kind in ("ref_fp8", "ref_int8"):
            rows = ref_readings(cell, flat, dev, seeds, kind[4:])
        else:
            raise SystemExit(f"unknown kind {kind!r}")
        for seed, numbers in rows:
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "seed": seed, **numbers}), flush=True)
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(r[n] for _, r in rows)
                         for n in check.NUMBERS}
        summary[kind]["seconds"] = time.perf_counter() - t0
    print(json.dumps({"workload": args.workload, "summary": summary}))


if __name__ == "__main__":
    main()
