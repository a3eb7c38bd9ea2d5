"""The rooflines' operations and bytes against a hand count, and the share
a traced slice gives."""

from __future__ import annotations

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark.lib import roofline, spec
from benchmark.lib.stats import PEAK_BF16_FLOPS, PEAK_BYTES
from benchmark.lib.trace import TraceSummary


def test_conv3x3_counts_by_hand():
    mod = spec.load_module("rooflines", "conv3x3")
    flops, n_bytes = mod.work((4, 6, 2, 3))
    # 24 pixels, each 9 taps x 2 in x 3 out multiply-adds.
    assert flops == 24 * 9 * 2 * 3 * 2
    # the map in (2 ch) and out (3 ch) in bf16, 54 bf16 weights, 3 f32 biases
    assert n_bytes == 24 * 2 * 2 + 24 * 3 * 2 + 54 * 2 + 3 * 4


def test_trunk_counts_by_hand():
    mod = spec.load_module("rooflines", "trunk")
    flops, n_bytes = mod.work((2, 4, 8, 3, 2))  # 2 windows of 2x2, dim 8
    n = 8  # tokens of the padded grid
    per_token = 12 * 8 * 8 + 2 * 4 * 8  # GEMMs, q.k and p.v
    assert flops == 3 * n * per_token * 2
    table = (2 * 2 - 1) ** 2 * 2
    assert n_bytes == 2 * n * 8 * 2 + 3 * (12 * 64 * 2 + 13 * 8 * 4
                                          + table * 4)


def test_fast_and_window_trunk_grids():
    fields = {"base_channels": 64, "transformer_dim": 192,
              "num_window_blocks": 6, "num_heads": 12, "window_size": 8,
              "patch_size": 8}
    fast = spec.load_module("reference", "fast_transformer")
    shapes = fast.kernel_shapes(720, 1280, (1080, 1920), fields)
    assert shapes["trunk"] == [(240, 64, 192, 6, 12)]  # 90x160 -> 96x160
    assert shapes["conv3x3"] == [(720, 1280, 64, 64)] * 2
    win = spec.load_module("reference", "window_transformer")
    shapes = win.kernel_shapes(720, 1280, (1080, 1920),
                               dict(fields, transformer_dim=128,
                                    num_window_blocks=8, num_heads=8))
    assert shapes["trunk"] == [(60, 64, 128, 8, 8)]  # 45x80 -> 48x80


def _summary(kernels, window_us=1000.0):
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "benchmark.traced_window", "ts": 0.0,
               "dur": window_us}]
    for ts, dur, name in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                       "dur": dur})
    return TraceSummary(events)


def test_share_reads_the_trace():
    shape = (720, 1280, 64, 64)
    least = roofline.least_seconds(*spec.load_module(
        "rooflines", "conv3x3").work(shape))
    assert least == pytest.approx(max(2.0 * 720 * 1280 * 9 * 64 * 64
                                      / PEAK_BF16_FLOPS,
                                      (720 * 1280 * 128 * 2 + 9 * 4096 * 2
                                       + 256) / PEAK_BYTES))
    us = least * 1e6 * 2  # each launch at half its roofline
    name = "void (anonymous namespace)::conv3x3_kernel<true, 0, false>(x)"
    launches = [(1000.0 * i, us, name) for i in range(200)]  # 100 frames
    rec = {"trace": _summary(launches + [(400.0, 5.0, "other_kernel")],
                             window_us=2e5),
           "kernel_shapes": {"conv3x3": [shape, shape]}, "trace_frames": 100}
    assert roofline.share(rec, "conv3x3") == pytest.approx(50.0)
    rec["kernel_shapes"] = {"conv3x3": [shape]}  # the route changed
    assert roofline.share(rec, "conv3x3") is None
    assert roofline.share(dict(rec, trace=None), "conv3x3") is None


def test_busy_idle_and_breakdown():
    s = _summary([(100.0, 200.0, "void a_kernel<1>(int)"),
                  (250.0, 100.0, "b_kernel(int)"),
                  (600.0, 2.0, "a_kernel<2>(int)")])
    assert s.busy_s == pytest.approx(252e-6)
    assert s.window_s == pytest.approx(1e-3)
    assert s.device_ops()[0] == ["a_kernel", pytest.approx(202e-6)]
    assert s.kernels(r"\ba_kernel\b") == (2, pytest.approx(202e-6))
    assert sum(v for _, v in s.idle_gaps()) == pytest.approx(748e-6)


def test_device_idle_reads_the_frames_events_outside_the_slice():
    """One minus (each frame's events span plus the slice's mean copy in)
    over the part's seconds; silent without events or copies."""
    idle = spec.load_module("layer_metrics", "device_idle")
    trace = _summary([(0.0, 100.0, "k(int)")])
    trace.device.append((200.0, 250.0, "Memcpy HtoD (Pinned -> Device)",
                         "gpu_memcpy"))  # 50 us a copy in
    rec = {"trace": trace, "part_s": 1.0, "frame_device_ms": [1.95] * 400}
    assert idle.read(rec) == pytest.approx(100.0 * (1 - 400 * 2.0 / 1e3))
    assert idle.read(dict(rec, frame_device_ms=[])) is None
    assert idle.read(dict(rec, trace=_summary([]))) is None
    live = spec.load_module("layer_metrics", "device_idle.live")
    assert live.read(rec) == idle.read(rec)
