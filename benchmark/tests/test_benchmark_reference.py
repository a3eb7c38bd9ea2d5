"""Each plain reference against the port's exact path at a tiny size on
the CPU (float32, the trained weights at full width), and its operation
count against a hand count."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark.lib import spec
from benchmark.lib.weights import load_flat, tree
from benchmark.reference.common import FP8_MAX, rnd, to_device

CASES = [("fast_transformer", (20, 36), (30, 54)),   # reflect pad, squash
         ("fast_transformer", (16, 32), (32, 64)),   # x2, no squash
         ("fast_transformer", (16, 24), (48, 72)),   # x3
         ("window_transformer", (36, 52), (54, 78)),
         ("window_transformer", (32, 48), (64, 96))]


def _config(name):
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


@pytest.mark.parametrize("name,hw,res_out", CASES,
                         ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}" for c in CASES])
def test_reference_matches_the_ports_exact_path(name, hw, res_out):
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax

    cfg = _config(name)
    flat = load_flat(cfg)
    model = get_model(cfg["model"], device="cpu", dtype=torch.float32,
                      **cfg["fields"])
    params_from_jax(model, tree(flat))
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(3))
    want = model(x, res_out=res_out)
    ref = spec.load_module("reference", cfg["reference"])
    got = ref.forward(to_device(flat, "cpu"), x.permute(0, 3, 1, 2),
                      res_out, cfg["fields"]).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 2e-5


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([0.0, 1.0, 1.1, -3.0, 448.0])
    y = rnd(x, "fp8")
    assert y[0] == 0 and y[-1] == 448.0 and y[1] == 1.0
    assert y[2] == pytest.approx(1.125)  # 1.1 to the nearest of 1/8 steps
    assert rnd(x, "f32") is x
    assert FP8_MAX == 448.0


def test_int8_rounding_keeps_127_steps_a_side():
    x = torch.tensor([0.0, 1.0, 0.5, -127.0, 127.0, 63.4])
    assert torch.equal(rnd(x, "int8"), torch.tensor(
        [0.0, 1.0, 0.0, -127.0, 127.0, 63.0]))  # halves round to even
    assert torch.equal(rnd(x / 127, "int8"), torch.round(x) / 127)


def test_flops_by_hand():
    fields = _config("fast_transformer")["fields"]
    fast = spec.load_module("reference", "fast_transformer")
    h, w = 16, 32  # x2 to 32x64, no squash; tokens 2x4, one padded window
    conv = lambda hh, ww, ci, co: 2.0 * hh * ww * 9 * ci * co  # noqa: E731
    want = (conv(h, w, 3, 64) + conv(h, w, 64, 64)
            + conv(h, w, 64, 256) + conv(32, 64, 64, 3)
            + conv(h, w, 3, 12) + conv(32, 64, 3, 3)
            + 2 * 2.0 * 8 * 4096 * 192
            + 6 * 64 * (2.0 * 12 * 192 * 192 + 2.0 * 2 * 64 * 192)
            + conv(h, w, 64, 64) + conv(h, w, 64, 3))
    assert fast.flops(h, w, (32, 64), fields) == want
    assert fast.flops(720, 1280, (1080, 1920), fields) == pytest.approx(
        5.59e11, rel=0.01)
    win = spec.load_module("reference", "window_transformer")
    wf = _config("window_transformer")["fields"]
    assert win.flops(720, 1280, (1080, 1920), wf) == pytest.approx(
        1.26e11, rel=0.02)
    assert np.isfinite(win.flops(33, 47, (50, 70), wf))
