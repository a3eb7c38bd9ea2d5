"""Plain versions of the port's conv and patch kernels
(transformerupscaler_torch/kernels/stream.py) against the JAX Pallas kernels
they replace, run in interpret mode on the CPU (the split tail is in
test_torch_split_tail.py, the trunk in test_torch_fused_trunk.py).

The Pallas kernels read the TPU's deinterleave4 layout; inputs are converted
at the boundary as tests/test_pallas_stream.py does (NHWC ->
reshape(b, h, w/2, 128) -> deinterleave4). On the CPU each wrapper computes
its plain version, so calling the wrapper tests the path the CPU takes.
Tolerance: tests/test_parity.py's atol=5e-5, rtol=1e-4 at f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops.pallas.stream import (
    conv3x3_deint_stream,
    conv3x3_packed_stream,
    deinterleave4,
    embed_stream as jax_embed_stream,
    interleave4,
    tail_macro8_stream,
    unembed_combine_stream as jax_unembed_combine_stream,
)
from transformerupscaler_torch import kernels as K
from transformerupscaler_torch.kernels import stream as S

TOL = dict(atol=5e-5, rtol=1e-4)


def _deint(x: np.ndarray):
    b, h, w, c = x.shape
    return deinterleave4(jnp.asarray(x).reshape(b, h, w // 2, 2 * c))


def _nhwc(xd) -> np.ndarray:
    xp = np.asarray(interleave4(xd), np.float32)
    b, h, wp2, c2 = xp.shape
    return xp.reshape(b, h, 2 * wp2, c2 // 2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_plain_matches_pallas(rng, relu):
    x = rng.standard_normal((1, 16, 64, 64)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = _nhwc(conv3x3_deint_stream(_deint(x), jnp.asarray(k),
                                      jnp.asarray(b), relu=relu, rows=8,
                                      interpret=True))
    got = S.conv3x3_stream(_t(x), _t(k), _t(b), relu=relu).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw", [(16, 64), (24, 32)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_plain_matches_packed_pallas(rng, relu, hw):
    """``conv3x3_packed_stream`` (stream.py:82) computes the same conv on the
    width-2 packed layout, a free reshape of NHWC at the boundary; the
    port's ``conv3x3_stream`` answers for it too."""
    h, w = hw
    x = rng.standard_normal((1, h, w, 64)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(conv3x3_packed_stream(
        jnp.asarray(x).reshape(1, h, w // 2, 128), jnp.asarray(k),
        jnp.asarray(b), relu=relu, rows=8, interpret=True))
    got = S.conv3x3_stream(_t(x), _t(k), _t(b), relu=relu).numpy()
    np.testing.assert_allclose(got, want.reshape(1, h, w, 64), **TOL)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("kh", [5, 7])
def test_tail_plain_matches_pallas(rng, kh, co, relu):
    """bf16 features and weights, f32 accumulation and f32 output: the
    serving arithmetic, compared at the f32 tolerance."""
    x = rng.standard_normal((1, 16, 64, 64)).astype(np.float32)
    k = (rng.standard_normal((kh, kh, 64, co)) * 0.05).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    xb = _deint(x).astype(jnp.bfloat16)
    want = np.asarray(tail_macro8_stream(xb, jnp.asarray(k), jnp.asarray(b),
                                         relu=relu, rows=8,
                                         out_dtype=jnp.float32,
                                         interpret=True)).reshape(1, 16, 64, co)
    got = S.tail_conv_stream(_t(x).bfloat16(), _t(k), _t(b), relu=relu,
                             out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_embed_plain_matches_pallas(rng):
    ht, wt, d = 2, 8, 96
    f = rng.standard_normal((1, 8 * ht, 8 * wt, 64)).astype(np.float32)
    k = (rng.standard_normal((8, 8, 64, d)) * 0.05).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(jax_embed_stream(_deint(f), jnp.asarray(k),
                                       jnp.asarray(b), interpret=True))
    got = S.embed_stream(_t(f), _t(k), _t(b)).numpy()
    assert got.shape == (1, ht, wt, d)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_unembed_combine_plain_matches_pallas(rng, relu):
    ht, wt, d = 2, 8, 64
    tok = rng.standard_normal((1, ht, wt, d)).astype(np.float32)
    k = (rng.standard_normal((d, 8, 8, 64)) * 0.05).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    f = rng.standard_normal((1, 8 * ht, 8 * wt, 64)).astype(np.float32)
    want = _nhwc(jax_unembed_combine_stream(jnp.asarray(tok), _deint(f),
                                            jnp.asarray(k), jnp.asarray(b),
                                            relu=relu, interpret=True))
    got = S.unembed_combine_stream(_t(tok), _t(f), _t(k), _t(b),
                                   relu=relu).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrappers_count_no_launches(rng):
    """On CPU tensors the wrappers run the plain versions and launch
    nothing, so the launch counts stay at zero."""
    S.reset_launches()
    x = _t(rng.standard_normal((1, 8, 16, 64)))
    S.conv3x3_stream(x, _t(rng.standard_normal((3, 3, 64, 64))), None)
    assert all(v == 0 for v in S.LAUNCHES.values())


def test_every_wrapper_has_a_counter_and_a_plain_version():
    """The package's explicit wrapper -> plain mapping covers every launch
    counter, and no wrapper is mapped to itself."""
    assert set(K.PLAIN_VERSIONS) == set(K.LAUNCHES)
    homes = {"fused_window_trunk": K.trunk2, "global_mha": K.gmha,
             "window_attention_core": K.window_attn}
    for name, plain in K.PLAIN_VERSIONS.items():
        wrapper = getattr(homes.get(name, S), name)
        assert callable(wrapper) and plain is not wrapper
        assert plain.__name__.endswith("_plain")


def test_wrapper_rejects_mixed_devices(rng):
    x = _t(rng.standard_normal((1, 8, 16, 64)))
    with pytest.raises(ValueError, match="devices"):
        S.conv3x3_stream(x, torch.zeros(3, 3, 64, 64, device="meta"))
