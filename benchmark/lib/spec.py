"""Find what a run needs by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, traffic kind,
per-layer metric, kernel roofline or reference model sits in a file of its
own under ``benchmark/``, found by name:

  configs/<config>.json          the configuration as it is run
  traffic/<traffic>.json         the traffic mix; its "driver" names the kind
  drivers/<driver>.py            the kind's driver: ``run(run) -> result``
  end_to_end/<metric>.py         ``read(record) -> float | None``
  layer_metrics/<metric>.py      ``read(record) -> float | None``
  rooflines/<kernel>.py          ``PATTERN`` and ``least_seconds(...)``
  reference/<reference>.py       the plain model: ``forward``, ``flops``, ...

so that a later change adds a cell, a configuration, a kind or a metric as
new files only.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _file(kind: str, name: str, suffix: str, bench: Path) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a plain name")
    path = bench / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    return path


def load_module(kind: str, name: str, bench: Path = BENCH_DIR):
    """The module ``benchmark/<kind>/<name>.py``. A name may hold dots
    (``device_idle.live``), so it is loaded by its path."""
    path = _file(kind, name, ".py", bench)
    mod_name = f"benchmark.{kind}.{name.replace('.', '__')}"
    mod = sys.modules.get(mod_name)
    if mod is not None and Path(mod.__file__).resolve() == path.resolve():
        return mod
    spec =importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and the metrics it reports."""

    def __init__(self, spec: dict, workload: str, bench: Path = BENCH_DIR):
        self.spec = spec
        self.bench = bench
        self.entry = _named(spec["workloads"], workload, "workload")
        self.name = workload
        cfg_entry = _named(spec["configs"], self.entry["config"], "config")
        cfg_path = bench.parent / cfg_entry["file"]
        self.config = load_json(cfg_path)
        self.traffic = load_json(_file("traffic", self.entry["traffic"],
                                       ".json", bench))
        self.chips = int(self.entry["chips"])

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self._reports(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.spec["per_layer"] if self._reports(m)]

    def driver(self):
        return load_module("drivers", self.traffic["driver"], self.bench)

    def reference(self):
        return load_module("reference", self.config["reference"], self.bench)

    def reader(self, metric: dict):
        """The reader of a metric of ``end_to_end`` or ``per_layer``."""
        kind = "layer_metrics" if "layer" in metric else "end_to_end"
        return load_module(kind, metric["name"], self.bench)
