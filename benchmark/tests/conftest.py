"""Shared fixtures of the benchmark's own tests.

    python -m pytest benchmark/tests            # CPU: the card's tests skip
    python3 -m pytest benchmark/tests -m gpu    # on the card

The root of the checkout goes on ``sys.path`` so that ``benchmark`` and the
port import as they do in a run.
"""

from __future__ import annotations

import json
import shutil
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` in a temporary
    checkout root: (root, spec dict). Tests add files there, never in the
    repository."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, json.loads((root / "BENCHMARK.json").read_text())


def tiny_traffic(driver: str, **extra) -> dict:
    """A traffic file's contents at a size a CPU test holds."""
    base = dict(driver=driver, why="a CPU test's tiny frames",
                res_in=[48, 80], res_out=[72, 120], ring=3, check_frames=4,
                bgr_out=driver == "stream_open")
    if driver == "stream_open":
        base.update(rate_hz=15.0, preroll_s=0.2)
    else:
        base.update(preroll_frames=3)
    base.update(extra)
    return base


# The closed-loop cells' end-to-end metric, which ``BENCHMARK.json`` does
# not hold yet (PERF.md, Open questions): a test that adds a closed-loop
# cell adds it too, as a later change would.
FRAMES_PER_S = dict(name="frames_per_s", unit="frames/s", better="higher",
                    bound=0.25, source="host_clock", workloads=[])


def add_cell(root: Path, spec: dict, name: str, config: str,
             traffic_name: str, traffic: dict,
             metrics: tuple = ()) -> dict:
    """Add a traffic file and a workload entry to a copied benchmark, and
    the cell to the ``workloads`` of the end-to-end and per-layer
    ``metrics`` it reports: new files and new entries only, as a later
    change would add them."""
    (root / "benchmark" / "traffic" / f"{traffic_name}.json").write_text(
        json.dumps(traffic))
    if "frames_per_s" in metrics and not any(
            m["name"] == "frames_per_s" for m in spec["end_to_end"]):
        spec["end_to_end"].insert(0, json.loads(json.dumps(FRAMES_PER_S)))
    spec["workloads"].append(dict(name=name, config=config,
                                  traffic=traffic_name, chips=1,
                                  why="a CPU test's cell"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


def cpu_run(cell, seed: int = 2 ** 31 + 11, seconds: float = 1.0):
    """A ``run.py`` ``Run`` for ``cell`` on the CPU: the harness's look for
    a card skipped, the rest of a run as it is."""
    import torch

    from benchmark import run as run_mod

    args = types.SimpleNamespace(workload=cell.name, seed=seed,
                                 seconds=seconds, trace=0)
    run = run_mod.Run(args, cell, torch.device("cpu"))
    run.device_record = lambda: {"platform": "cpu", "kind": "cpu",
                                 "count": 1, "memory_peak_bytes": 0}
    run.log = lambda *a: None
    return run
