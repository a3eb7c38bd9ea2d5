"""The fused trunk kernel's branch-free erf (csrc/window_trunk.cu
``erf_branchless``), which its bf16 modes' GELU evaluates, against erf in
float64 on the CPU: its two polynomials, read from the source, evaluated as
the kernel evaluates them (f32 fused multiply-adds; the 2^x term exact), are
within 1.2 units in the last place of f32 over [-5, 5]. The card's
``ex2.approx`` adds at most 2^-22 of that term (<= 0.16 where it is used,
so under 0.7 ulp of a result in [0.84, 1)): the kernel's erf is within 2
ulp, as CUDA's ``erff`` is."""

import math
import os
import re

import numpy as np

from _torch_threads import one_torch_thread  # noqa: F401

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "transformerupscaler_torch", "csrc", "window_trunk.cu")


def _coefficients(name: str) -> np.ndarray:
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(rf"constexpr float {name}\[\] = \{{(.*?)\}};", text,
                     re.S).group(1)
    return np.array([float(v.rstrip("f")) for v in
                     re.findall(r"[-+0-9.e]+f", body)], np.float32)


def _fma(a, b, c):
    """f32 fused multiply-add: the exact f64 product and sum, rounded once
    (exact here: f32 products fit f64's 53 bits)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _erf_near(x: np.ndarray) -> np.ndarray:
    q = _coefficients("ERF_Q")
    s = (x.astype(np.float64) * x).astype(np.float32)
    p = np.full_like(x, q[-1])
    for c in q[-2::-1]:
        p = _fma(p, s, c)
    return _fma(p, x, x)


def _erfc_far(u: np.ndarray) -> np.ndarray:
    r = _coefficients("ERF_R")
    w = np.full_like(u, r[-1])
    for c in r[-2::-1]:
        w = _fma(w, u, c)
    u2 = (u.astype(np.float64) * u).astype(np.float32)
    e = _fma(-u2, np.float32(1.4426950408889634), w)
    return np.exp2(e.astype(np.float64)).astype(np.float32)


def _kernel_erf(x: np.ndarray) -> np.ndarray:
    t = np.abs(x)
    far = (1.0 - _erfc_far(np.minimum(t, np.float32(4.0)))
           .astype(np.float64)).astype(np.float32)
    return np.where(t <= 1.0, _erf_near(x), np.copysign(far, x))


def _kernel_one_plus_erf_i8(x: np.ndarray) -> np.ndarray:
    """``gelu_i8``'s 1 + erf(x): 1 + erf_near, 2 - erfc_far or erfc_far
    (0 below x = -4), in f32."""
    f32 = np.float32
    t = np.abs(x)
    e = np.where(t < 4.0, _erfc_far(np.minimum(t, f32(4.0))), f32(0.0))
    return np.where(t <= 1.0, (f32(1.0) + _erf_near(x)).astype(f32),
                    np.where(x > 0, (f32(2.0) - e).astype(f32), e))


def _kernel_gelu_i8(h: np.ndarray) -> np.ndarray:
    x = (h * np.float32(0.70710678118654752)).astype(np.float32)
    return ((np.float32(0.5) * h).astype(np.float32)
            * _kernel_one_plus_erf_i8(x)).astype(np.float32)


def test_branchless_erf_within_1_2_ulp():
    assert len(_coefficients("ERF_Q")) == 7
    assert len(_coefficients("ERF_R")) == 9
    x = np.concatenate([np.linspace(-5, 5, 400_001, dtype=np.float32),
                        np.float32([0.0, 1.0, -1.0, 3.92, 4.0, 1e-30])])
    got = _kernel_erf(x).astype(np.float64)
    want = np.array([math.erf(float(v)) for v in x])
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(got - want) / ulp
    assert err.max() <= 1.2, (float(err.max()), float(x[err.argmax()]))
    assert np.all(got[np.abs(x) >= 3.92] == np.sign(x[np.abs(x) >= 3.92]))


def test_int8_gelu_sides_monotone():
    """The int8 modes' GELU (``gelu_i8``), emulated, rounded to bf16 as
    their epilogues round it, at every finite bf16 input: it never falls on
    h >= 0, and its magnitude never falls on h <= GELU_TURN nor rises on
    GELU_TURN < h < 0, which lets the rowwise mode's first pass take a row's
    largest |GELU output| from three inputs (tests/test_torch_gpu.py checks
    the card's own). Its 1 + erf is within 3e-6 of 1 + erf in float64,
    relative, on (-4, 4] (the erfc fit's own error below x = -1)."""
    import torch

    with open(SOURCE) as f:
        turn = float(re.search(r"constexpr float GELU_TURN = ([-0-9.]+)f;",
                               f.read()).group(1))
    d = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    d = np.unique(d[np.isfinite(d)])
    with np.errstate(over="ignore", invalid="ignore"):
        h = torch.from_numpy(_kernel_gelu_i8(d)).bfloat16().float().numpy()
    assert np.isfinite(h).all()
    assert np.all(np.diff(h[d >= 0]) >= 0)
    assert np.all(np.diff(np.abs(h[d <= turn])) >= 0)
    assert np.all(np.diff(np.abs(h[(d > turn) & (d < 0)])) <= 0)
    x = np.linspace(-4, 4, 80_001, dtype=np.float32)[1:]
    got = _kernel_one_plus_erf_i8(x).astype(np.float64)
    want = np.array([1.0 + math.erf(float(v)) for v in x])
    rel = np.abs(got - want) / want
    assert rel.max() <= 3e-6, (float(rel.max()), float(x[rel.argmax()]))
