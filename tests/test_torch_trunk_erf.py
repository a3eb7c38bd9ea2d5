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


def _kernel_erf(x: np.ndarray) -> np.ndarray:
    q, r = _coefficients("ERF_Q"), _coefficients("ERF_R")
    t = np.abs(x)
    s = (x.astype(np.float64) * x).astype(np.float32)
    p = np.full_like(x, q[-1])
    for c in q[-2::-1]:
        p = _fma(p, s, c)
    near = _fma(p, x, x)
    u = np.minimum(t, np.float32(4.0))
    w = np.full_like(x, r[-1])
    for c in r[-2::-1]:
        w = _fma(w, u, c)
    u2 = (u.astype(np.float64) * u).astype(np.float32)
    e = _fma(-u2, np.float32(1.4426950408889634), w)
    far = (1.0 - np.exp2(e.astype(np.float64)).astype(np.float32)
           .astype(np.float64)).astype(np.float32)
    return np.where(t <= 1.0, near, np.copysign(far, x))


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
