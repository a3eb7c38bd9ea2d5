"""The comparison that decides ``correct`` fails a broken timed path: a run
is driven on the CPU at a tiny size with the harness's look for a card
skipped and the pipeline's step broken underneath (the frame it makes
altered where it is made), and ``correct`` comes out false; the control
(the next precision below bf16) fails the limits on the card at the
cell's own size."""

from __future__ import annotations

import pytest
import torch
from conftest import add_cell, cpu_run, tiny_traffic

from benchmark import run as run_mod
from benchmark.lib import spec as spec_mod
from transformerupscaler_torch.stream_lib import StreamPipeline

CONFIGS = ("fast_transformer", "window_transformer")


def _stale(step):
    """A step that returns its state unchanged: the previous frame's
    output for every frame after the first."""
    last = {}

    def broken(self, frame):
        out = step(self, frame)
        prev = last.get("out")
        last["out"] = out
        return out if prev is None else prev
    return broken


def _swapped(step):
    """The channels in the wrong order (RGB for BGR)."""
    return lambda self, frame: step(self, frame).flip(-1)


def _shifted(step):
    """Every row one row off."""
    return lambda self, frame: torch.roll(step(self, frame), 1, dims=0)


FAULTS = {"none": None, "stale": _stale, "swapped": _swapped,
          "shifted": _shifted}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("config", CONFIGS)
def test_a_broken_step_is_not_correct(bench_copy, monkeypatch, config,
                                      fault):
    root, spec = bench_copy
    name = f"{config}_tiny"
    add_cell(root, spec, name, config, "tiny_closed",
             tiny_traffic("stream_closed"), metrics=("frames_per_s",))
    if FAULTS[fault] is not None:
        monkeypatch.setattr(StreamPipeline, "_step",
                            FAULTS[fault](StreamPipeline._step))
    cell = spec_mod.Cell(spec, name, bench=root / "benchmark")
    out = run_mod.result(cell, cell.driver().run(cpu_run(cell)), False)
    assert out["correct"] is (fault == "none"), out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["fast_live_1080p_4k",
                                      "fast_live_720p_1080p",
                                      "window_live_720p_1080p"])
def test_the_control_fails_at_the_cells_size(card, workload):
    """The port's own int8 path (FastTransformer) or the reference in fp8
    (WindowTransformer, which has no int8 path on its route) against the
    config's limits, one seed; the program itself passes them."""
    from benchmark import control
    from benchmark.lib import check
    from benchmark.lib.weights import load_flat

    cell = spec_mod.Cell(spec_mod.benchmark_spec(), workload)
    flat = load_flat(cell.config)
    seeds = [4242]
    ((_, sound),) = control.pipeline_readings(cell, flat, card, seeds, 1.0)
    assert check.judge(sound, cell.config["limits"])[0]
    if cell.config["model"] == "FastTransformer":
        ((_, bad),) = control.pipeline_readings(cell, flat, card, seeds, 1.0,
                                                {"int8": "full"})
    else:
        ((_, bad),) = control.ref_readings(cell, flat, card, seeds, "fp8")
    assert not check.judge(bad, cell.config["limits"])[0]
