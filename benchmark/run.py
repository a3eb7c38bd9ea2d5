"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are found by name (``BENCHMARK.json``, ``benchmark/lib/spec.py``); the
traffic's driver runs the port (``transformerupscaler_torch``) on the card:
set-up, a measured window of ``--seconds``, then the comparison with the
plain reference that decides ``correct``. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the device's busy time from a profiled slice of the window, and
the breakdown.

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key. No card, too few cards, a JAX module in
the process after the window, or a metric that cannot be read: an error,
exit code other than 0, no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The port builds its kernels at first use into build/torch_kernels and
# build/torch_native inside the checkout (kernels/_build.py, native.py),
# fixed paths, so only a checkout's first run builds; it uses neither
# torch.utils.cpp_extension nor Triton.
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Run:
    """What a driver gets: the arguments, the cell, the card, the time the
    process started, and where to say things."""

    def __init__(self, args, cell, device):
        self.args, self.cell, self.device = args, cell, device
        self.t_start = T_START
        self.log = log

    def device_record(self) -> dict:
        from benchmark.lib.device import device_record

        return device_record(self.cell.chips)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(cell, rec: dict, traced: bool) -> dict:
    """The result line from a driver's record."""
    metrics = {}
    for m in (cell.per_layer() if traced else cell.end_to_end()):
        value = cell.reader(m).read(rec)
        if value is None:
            if traced:
                log(f"per-layer metric {m['name']}: nothing to read")
                continue
            raise SystemExit(f"end-to-end metric {m['name']} has no value")
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(rec["device"])
    out = {"correct": bool(rec["checks"]["correct"] and rec["failed"] == 0),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": device}
    summary = rec.get("trace")
    if traced:
        if summary is None:
            raise SystemExit("the traced run holds no trace")
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops(),
                            "idle_gaps": summary.idle_gaps()}
    out["checks"] = rec["checks"]["shown"]
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.lib import device, spec

    cell = spec.Cell(spec.benchmark_spec(), args.workload)
    card = device.require_cards(cell.chips)
    log(f"cell {cell.name}: config {cell.entry['config']}, traffic "
        f"{cell.entry['traffic']}, seed {args.seed}, {args.seconds:g} s, "
        f"trace {args.trace}")
    rec = cell.driver().run(Run(args, cell, card))
    log(f"card: {device.power_limit()}")
    bad = device.forbidden_modules()
    if bad:
        raise SystemExit(f"the process holds modules of the JAX package or "
                         f"its stack: {', '.join(bad)}")
    out = result(cell, rec, bool(args.trace))
    checks = rec["checks"]
    log(f"numbers: {json.dumps(checks.get('numbers'))}")
    if "why" in checks:
        log(f"check: {checks['why']}")
    log(f"check over {checks['frames']} frames, failed {out['failed']} of "
        f"{out['attempted']}:")
    for name, v in out["checks"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
