"""The benchmark finds everything by name, keeps to its contract's shape,
and takes a new cell as new files only."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT, add_cell, cpu_run, tiny_traffic

from benchmark.lib import spec as spec_mod

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_is_found_and_published(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["reduced"] == []
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == []
    spec_mod.load_module("reference", cfg["reference"])
    from benchmark.lib.weights import count, load_flat

    assert count(load_flat(cfg)) == cfg["parameters"]
    assert cfg["limits"], "every config states the limits of its check"


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_is_found_with_its_metrics(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    cell = spec_mod.Cell(SPEC, entry["name"])
    cell.driver()
    cell.reference()
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.per_layer()
    assert layer
    for m in cell.end_to_end() + layer:
        assert hasattr(cell.reader(m), "read")
    for m in layer:
        assert m["moves"] in e2e


def test_metrics_follow_the_contract():
    names = set()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            mod = spec_mod.load_module("rooflines", kernel)
            assert mod.PATTERN and m["unit"] == "%"


def test_a_new_cell_is_new_files_only(bench_copy):
    """A traffic file of an existing driver and a workload entry: the cell
    is found and runs, no file of the benchmark edited."""
    root, spec = bench_copy
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = add_cell(root, spec, "fast_tiny_closed", "fast_transformer",
                    "tiny_closed", tiny_traffic("stream_closed"),
                    metrics=("frames_per_s",))
    for p, data in before.items():
        assert p.read_bytes() == data
    cell = spec_mod.Cell(spec, "fast_tiny_closed", bench=root / "benchmark")
    assert cell.traffic["res_in"] == [48, 80]
    from benchmark import run as run_mod

    rec = cell.driver().run(cpu_run(cell))
    out = run_mod.result(cell, rec, traced=False)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(out)[-1] == "checks" and out["checks"]


def test_a_new_config_and_metric_are_new_files_only(bench_copy):
    """A configuration file (the same model, another name) and a per-layer
    metric reader, added as files, are found by name."""
    root, spec = bench_copy
    cfg = json.loads((root / "benchmark/configs/window_transformer.json")
                     .read_text())
    cfg["name"] = "window_copy"
    (root / "benchmark/configs/window_copy.json").write_text(json.dumps(cfg))
    (root / "benchmark/layer_metrics/frames_seen.py").write_text(
        "def read(rec):\n    return rec.get('frames') or None\n")
    spec["configs"].append(dict(name="window_copy", source=cfg["source"],
                                file="benchmark/configs/window_copy.json",
                                reduced=[], why="a copy"))
    spec["per_layer"].append(dict(name="frames_seen", unit="frames",
                                  better="higher", source="host_clock",
                                  layer="pipeline", moves="setup_s",
                                  workloads=["window_copy_tiny"]))
    add_cell(root, spec, "window_copy_tiny", "window_copy", "tiny_open",
             tiny_traffic("stream_open"))
    cell = spec_mod.Cell(spec, "window_copy_tiny", bench=root / "benchmark")
    assert cell.config["name"] == "window_copy"
    (metric,) = [m for m in cell.per_layer() if m["name"] == "frames_seen"]
    assert cell.reader(metric).read({"frames": 7}) == 7
