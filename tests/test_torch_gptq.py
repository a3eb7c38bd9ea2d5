"""The offline GPTQ int8 weights in the port: ``ops/gptq.py`` (the port's
numpy copy), ``UpscalerEngine.gptq_int8`` and ``FastTransformer
.int8_weights``, against the JAX package on the CPU.

- ``im2col_patches``, ``gptq_quantize`` and ``quantize_conv_gptq``: bit for
  bit with JAX's on seeded inputs.
- The engine's entries against JAX's, from the committed fixture
  (tests/fixtures/torch_port/gptq_FastTransformer.npz: the JAX engine as
  bench.py builds ``int8_full``, trained weights, ``calibrate_int8`` and
  ``gptq_int8`` with their defaults on FastTransformer's demo input cut to
  176x320). Given JAX's calibration, the entries' scales of conv1 and conv2
  are bit for bit; tail A's differ by f32 rounding (the port composes the
  5x5 tail kernel with other f32 summation orders than XLA: measured 9e-8 on
  weights up to 0.19), bound 1e-6 relative. The int8 kernels' share of
  differing entries is measured (0 at the fixture's) and bound at 1%, one
  step at most; biases within 1e-6. The port's own calibration gives
  feat1 and feat within 1e-6 relative of JAX's (one bf16 rounding of
  conv1's output apart in a few channels).
- The port model with JAX's entries against JAX's model with the same
  entries (the fixture's outputs, on a 64x128 crop at x2, trained weights,
  bf16), on both ``pallas_serve`` forms, within chip_smoke.py's int8 limit
  (interior max 1.5e-2, mean 2.5e-3).
- Where each entry is read (the rules of ``models/fast_transformer.py``):
  conv2 only off ``pallas_serve``, tail A under "full" and under "tails"
  unless ``TUX_INT8_TAIL=pallas``, tail B under "tails" likewise, not x6's
  direct int8 tails under "tails", never "conv1"; an entry's bias replaces
  the layer's.

Regenerate the fixture with ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_gptq.py`` (~2 min).
"""

import os

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.models import fast_transformer as FT
from transformerupscaler_torch.ops import gptq
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")
FIXTURE = os.path.join(DIR, "gptq_FastTransformer.npz")
TRAINED = os.path.join(DIR, "trained_FastTransformer.npz")
# bench.py's int8_full (bench.py:87-115) and the int8_full route on the
# stream kernels.
INT8_FULL_XLA = dict(compose_tails=True, int8_serve=True, int8_scope="full",
                     pallas_serve=False, attn_impl="xla")
INT8_FULL_PALLAS = dict(compose_tails=True, int8_serve=True,
                        int8_scope="full", pallas_serve=True,
                        attn_impl="fused2")
NAMES = ("conv1", "conv2", "tailA_s2")
CROP = (slice(56, 120), slice(96, 224))  # 64x128 of the 176x320 frame
INT8_LIMIT = (1.5e-2, 2.5e-3)
SCALE_NAMES = ("feat1", "feat", "combined", "dec", "tokens")
SMALL = dict(transformer_dim=32, num_window_blocks=1, num_heads=2)


def demo_frame() -> np.ndarray:
    with np.load(TRAINED) as f:
        return f["x"][:176]


def entries_from(f) -> tuple:
    """JAX's ``int8_weights`` tuple from the fixture's arrays."""
    return tuple((n, tuple(f[f"kq_{n}"].shape), f[f"kq_{n}"].tobytes(),
                  f[f"ks_{n}"].tobytes(), f[f"b_{n}"].tobytes())
                 for n in NAMES)


def jax_gptq_fixture() -> dict:
    import jax.numpy as jnp

    from transformerupscaler_tpu.infer_lib import UpscalerEngine as JaxEngine
    from transformerupscaler_tpu.registry import get_model as jax_get_model
    from transformerupscaler_torch.checkpoint import (
        default_checkpoint_dir,
        fingerprint,
        get_latest_checkpoint,
    )

    x = demo_frame()
    eng = JaxEngine("FastTransformer", dtype=jnp.bfloat16, **INT8_FULL_XLA)
    scales = eng.calibrate_int8(x, upscale_factor=2)
    eng.gptq_int8(x)
    out = dict(x=x, fingerprint=np.array(fingerprint(get_latest_checkpoint(
        default_checkpoint_dir("FastTransformer"))[0])))
    for n, s in zip(SCALE_NAMES, scales):
        out[f"scale_{n}"] = np.asarray(s, np.float64)
    for name, shape, kq, ks, bb in eng.model.int8_weights:
        out[f"kq_{name}"] = np.frombuffer(kq, np.int8).reshape(shape)
        out[f"ks_{name}"] = np.frombuffer(ks, np.float32)
        out[f"b_{name}"] = np.frombuffer(bb, np.float32)
    xc = x[CROP].astype(np.float32)[None] / 255.0
    for tag, flags in (("xla", INT8_FULL_XLA), ("pallas", INT8_FULL_PALLAS)):
        jm = jax_get_model("FastTransformer", dtype=jnp.bfloat16,
                           int8_scales=scales,
                           int8_weights=eng.model.int8_weights, **flags)
        y = jm.apply(eng._params, jnp.asarray(xc), upscale_factor=2)
        out[f"y_{tag}"] = np.asarray(y.astype(jnp.float32))
    return out


@pytest.fixture(scope="module")
def fix():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_gptq_functions_are_jax_bit_for_bit():
    from transformerupscaler_tpu.ops import gptq as jax_gptq

    rng = np.random.default_rng(0)
    feat = rng.random((2, 12, 14, 8)).astype(np.float32)
    np.testing.assert_array_equal(gptq.im2col_patches(feat, 3, 3, 500, 4),
                                  jax_gptq.im2col_patches(feat, 3, 3, 500, 4))
    mix = rng.standard_normal((24, 24)) * 0.3 + np.eye(24)
    xs = rng.standard_normal((2000, 24)) @ mix
    w = rng.standard_normal((24, 5)) * 0.1
    w[3] = 0.0
    hess = xs.T @ xs
    hess[7, :] = hess[:, 7] = 0.0  # a dead input
    for a, b in zip(gptq.gptq_quantize(w, hess),
                    jax_gptq.gptq_quantize(w, hess)):
        np.testing.assert_array_equal(a, b)
    kern = rng.standard_normal((5, 5, 8, 6)).astype(np.float32) * 0.1
    bias = rng.standard_normal(6).astype(np.float32)
    s_in = rng.random(8) * 0.02 + 0.001
    for a, b in zip(gptq.quantize_conv_gptq(kern, feat, s_in, 700, bias, 2),
                    jax_gptq.quantize_conv_gptq(kern, feat, s_in, 700, bias,
                                                2)):
        np.testing.assert_array_equal(a, b)


def test_engine_entries_match_jax(fix):
    from transformerupscaler_torch.infer_lib import UpscalerEngine

    eng = UpscalerEngine("FastTransformer", dtype=torch.bfloat16,
                         device="cpu", **INT8_FULL_XLA)
    with pytest.raises(RuntimeError, match="calibrate_int8"):
        eng.gptq_int8(fix["x"])
    scales = eng.calibrate_int8(fix["x"], upscale_factor=2)
    for n, s in zip(("feat1", "feat"), scales):
        want = fix[f"scale_{n}"]
        assert np.abs(np.asarray(s) - want).max() <= 1e-6 * want.max(), n
    # Entries from the same calibration as JAX's.
    eng._calib_scales = {n: fix[f"scale_{n}"] for n in SCALE_NAMES}
    eng.gptq_int8(fix["x"])
    got = {e[0]: e for e in eng.model.int8_weights}
    assert tuple(got) == NAMES and eng._cache == {}
    for n in NAMES:
        _, shape, kq, ks, bb = got[n]
        kq = np.frombuffer(kq, np.int8).reshape(shape)
        ks, bb = np.frombuffer(ks, np.float32), np.frombuffer(bb, np.float32)
        want_ks = fix[f"ks_{n}"]
        if n == "tailA_s2":
            np.testing.assert_allclose(ks, want_ks, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(ks, want_ks)
        d = np.abs(kq.astype(int) - fix[f"kq_{n}"])
        assert shape == fix[f"kq_{n}"].shape
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (n, (d > 0).mean())
        np.testing.assert_allclose(bb, fix[f"b_{n}"], rtol=0, atol=1e-6)
    # The model keeps calibrate_int8's static scales.
    assert eng.model.int8_scales == tuple(tuple(map(float, s))
                                          for s in scales)


@pytest.mark.parametrize("tag,flags", [("xla", INT8_FULL_XLA),
                                       ("pallas", INT8_FULL_PALLAS)])
def test_model_with_jax_entries_matches_jax(fix, tag, flags):
    from transformerupscaler_torch.checkpoint import load_latest_params

    scales = tuple(tuple(fix[f"scale_{n}"].tolist()) for n in SCALE_NAMES)
    model = get_model("FastTransformer", device="cpu", dtype=torch.bfloat16,
                      int8_scales=scales, int8_weights=entries_from(fix),
                      **flags)
    params_from_jax(model, load_latest_params("FastTransformer"))
    xc = fix["x"][CROP].astype(np.float32)[None] / 255.0
    got = model(torch.from_numpy(xc), upscale_factor=2).float().numpy()
    want = fix[f"y_{tag}"]
    assert got.shape == want.shape == (1, 128, 256, 3)
    err = np.abs(got - want)[:, 4:-4, 4:-4]
    assert err.max() <= INT8_LIMIT[0] and err.mean() <= INT8_LIMIT[1], (
        err.max(), err.mean())


class _Spy:
    """Records the kernels the int8 convs get (by their value where all
    their values are one, as each entry's are) and their biases."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("conv3x3_int8_stream", "tail_conv_int8_stream",
                     "conv2d_int8_mm"):
            real = getattr(FT, name)

            def spy(xq, kq, ks, bias=None, *a, _real=real, _name=name, **kw):
                first = int(kq.flatten()[0])
                self.calls.append((_name,
                                   first if bool((kq == first).all())
                                   else None,
                                   None if bias is None
                                   else float(bias.flatten()[0])))
                return _real(xq, kq, ks, bias, *a, **kw)

            monkeypatch.setattr(FT, name, spy)

    def read(self):
        """{kernel value: bias value} of the calls that got an entry."""
        return {k: b for _, k, b in self.calls if k in MARKS.values()}


MARKS = {"conv1": 11, "conv2": 22, "tailA_s2": 33, "tailB_s2": 44,
         "tailA_s6": 66, "tailB_s6": 77}


def _marked_entries(names, shapes):
    """One entry per name: its kernel all MARKS[name], scales 1e-3, bias
    MARKS[name] / 1000 (None for conv1)."""
    out = []
    for n in names:
        shape = shapes[n]
        kq = np.full(shape, MARKS[n], np.int8)
        ks = np.full(shape[-1], 1e-3, np.float32)
        bias = None if n == "conv1" else np.full(shape[-1], MARKS[n] / 1000,
                                                 np.float32).tobytes()
        out.append((n, shape, kq.tobytes(), ks.tobytes(), bias))
    return tuple(out)


SHAPES = {"conv1": (3, 3, 3, 64), "conv2": (3, 3, 64, 64),
          "tailA_s2": (5, 5, 64, 12), "tailB_s2": (7, 7, 64, 12),
          "tailA_s6": (5, 5, 64, 108), "tailB_s6": (7, 7, 64, 108)}
# (scope, pallas_serve, scale, TUX_INT8_TAIL) -> the entries read
CONSUMED = [
    (("full", False, 2, None), {"conv2", "tailA_s2"}),
    (("full", True, 2, None), {"tailA_s2"}),
    (("tails", True, 2, None), {"tailA_s2", "tailB_s2"}),
    (("tails", True, 2, "pallas"), set()),
    (("tails", True, 6, None), set()),
    (("full", True, 6, None), {"tailA_s6"}),
    (("residual", True, 2, None), set()),
]


@pytest.mark.parametrize("case,want", CONSUMED,
                         ids=["-".join(map(str, c)) for c, _ in CONSUMED])
def test_entries_are_read_where_jax_reads_them(monkeypatch, case, want):
    scope, pallas, scale, env = case
    if env is None:
        monkeypatch.delenv("TUX_INT8_TAIL", raising=False)
    else:
        monkeypatch.setenv("TUX_INT8_TAIL", env)
    spy = _Spy(monkeypatch)
    model = get_model("FastTransformer", device="cpu", dtype=torch.float32,
                      compose_tails=True, int8_serve=True, int8_scope=scope,
                      pallas_serve=pallas, attn_impl="xla",
                      int8_weights=_marked_entries(MARKS, SHAPES), **SMALL)
    params_from_jax(model, seeded_params(model, 1))
    x = torch.rand(1, 16, 32, 3, generator=torch.Generator().manual_seed(0))
    model(x, upscale_factor=scale)
    got = spy.read()
    assert set(got) == {MARKS[n] for n in want}
    for n in want:
        assert got[MARKS[n]] == pytest.approx(MARKS[n] / 1000)


def test_conv1_entry_and_bias_none():
    """The conv1 entry changes nothing; an entry with bias None keeps the
    layer's bias (the output equals the same entry given with that bias);
    clear_derived drops the decoded entries."""
    x = torch.rand(1, 16, 32, 3, generator=torch.Generator().manual_seed(0))

    def run(entries):
        m = get_model("FastTransformer", device="cpu", dtype=torch.float32,
                      **INT8_FULL_XLA, int8_weights=entries, **SMALL)
        params_from_jax(m, seeded_params(m, 1))
        return m, m(x, upscale_factor=2)

    conv2 = _marked_entries(["conv2"], SHAPES)[0]
    _, base = run((conv2,))
    _, with_conv1 = run((conv2,) + _marked_entries(["conv1"], SHAPES))
    torch.testing.assert_close(with_conv1, base, rtol=0, atol=0)
    m, no_bias = run((conv2[:4] + (None,),))
    layer_bias = m.conv2.bias.numpy().astype(np.float32).tobytes()
    _, given = run((conv2[:4] + (layer_bias,),))
    torch.testing.assert_close(no_bias, given, rtol=0, atol=0)
    assert any(k[0] == "int8_weights" for k in m._int8)
    m.clear_derived()
    assert not any(k[0] == "int8_weights" for k in m._int8)
    with pytest.raises(ValueError, match="int8_weights"):
        get_model("FastTransformer", device="cpu",
                  int8_weights=(("conv2", (1,), b"", b""),), **SMALL)


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **jax_gptq_fixture())
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")
