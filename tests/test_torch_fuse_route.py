"""FastTransformer's streamed conv1 and fused conv + tail routes in the port
against the JAX model ``_packed_forward`` on the CPU (the JAX Pallas kernels
in interpret mode, the port's wrappers on their plain versions).

Set-up of tests/test_torch_fast_transformer.py: a small trunk (dim 32, 2
heads of 16, 2 blocks), the same seeded weights on both sides, a 16x32
input, x2 with the squash (res_out 24x48), the route of bench.py
(``compose_tails=True, pallas_serve=True, attn_impl="fused2"``):

- f32 with ``TUX_FUSE_STREAM=1`` and f32 with ``conv1_stream=True``, to
  tests/test_parity.py:69's atol=5e-5, rtol=1e-4 (measured max abs 1.8e-7);
- the int8 scopes that fuse part of the forward, bf16 with dynamic scales:
  "tails" with ``TUX_FUSE_STREAM=1`` (the decoder fused in bf16 on the
  unembed's output with the int8 skip) and ``TUX_CONV1_STREAM=""`` (on: any
  value but "0"), and "residual" with ``TUX_FUSE_STREAM=1`` (the encoder
  fused in bf16, the decoder int8), interior max <= 1e-2 and mean <= 1e-3 as
  tests/test_torch_int8_scopes.py holds the scopes, and the same scales
  sown and used (the feature scale, taken before any sum in another order,
  equal; the others within 3%).

Which kernels a forward calls is compared with the JAX model's calls for a
matrix of switches, field values and scopes (``jax.eval_shape`` traces the
JAX forward without running it). Each JAX forward runs once per module.

The fixture chip_smoke.py holds the route ``bench_fuse`` to on the card,
tests/fixtures/torch_port/fuse_stream_x2_bf16.npz, is generated here: the
bf16 output of the JAX FastTransformer at full model width in the
configuration of bench_x2_bf16.npz (tests/test_torch_fixtures.py: the
bench.py route, 24x144 -> 36x216, seed 7, weights from ``seeded_params``)
with ``TUX_FUSE_STREAM=1``, the fused Pallas kernels in interpret mode. The
streamed conv1 needs no fixture of its own: JAX's is bit-exact with its
default conv1, so ``bench_conv1`` is held against bench_x2_bf16.npz.
Regenerate with ``PYTHONPATH=. python tests/test_torch_fuse_route.py`` from
the repo root.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import transformerupscaler_tpu.ops.pallas.stream as jax_stream
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.models import fast_transformer as FT
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

from test_torch_fixtures import (
    BENCH_IN_HW,
    BENCH_RES_OUT,
    BENCH_ROUTE,
    DIR,
    _assert_fresh,
    _assert_port_matches,
    jax_fixture,
)

SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
X = np.random.default_rng(1).random((1, 16, 32, 3)).astype(np.float32)
RES_OUT = (24, 48)
ENV = ("TUX_FUSE_STREAM", "TUX_CONV1_STREAM")
# name -> (dtype, model fields, environment)
RUNS = {
    "fuse_f32": ("float32", {}, {"TUX_FUSE_STREAM": "1"}),
    "conv1_f32": ("float32", dict(conv1_stream=True), {}),
    "tails_fuse_conv1": ("bfloat16", dict(int8_serve=True,
                                          int8_scope="tails"),
                         {"TUX_FUSE_STREAM": "1", "TUX_CONV1_STREAM": ""}),
    "residual_fuse": ("bfloat16", dict(int8_serve=True,
                                       int8_scope="residual"),
                      {"TUX_FUSE_STREAM": "1"}),
}


@contextlib.contextmanager
def environ(values: dict):
    """Exactly ``values`` for the switches in ``ENV`` inside, the old
    values restored after."""
    saved = {k: os.environ.get(k) for k in ENV}
    try:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update(values)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port(dtype, **fields):
    model = get_model("FastTransformer", device="cpu",
                      dtype=getattr(torch, dtype), **ROUTE, **SMALL,
                      **fields)
    tree = seeded_params(model, 3)
    params_from_jax(model, tree)
    return model, tree


def _jax_model(dtype, **fields):
    return jax_get_model("FastTransformer", dtype=jnp.dtype(dtype), **ROUTE,
                         **SMALL, **fields)


@pytest.fixture(scope="module")
def jax_runs():
    """name -> (JAX output, its sown int8 scales)."""
    out = {}
    for name, (dtype, fields, env) in RUNS.items():
        _, tree = _port(dtype, **fields)
        with environ(env):
            y, inter = _jax_model(dtype, **fields).apply(
                {"params": tree}, jnp.asarray(X), res_out=RES_OUT,
                mutable=["intermediates"])
        sown = {k: np.asarray(v[0])
                for k, v in inter.get("intermediates", {}).items()}
        out[name] = (np.asarray(y, np.float32), sown)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_route_matches_jax(jax_runs, name):
    dtype, fields, env = RUNS[name]
    model, _ = _port(dtype, **fields)
    with environ(env):
        got = model(torch.from_numpy(X), res_out=RES_OUT).float().numpy()
    want, sown = jax_runs[name]
    assert got.shape == want.shape == (1, *RES_OUT, 3)
    if dtype == "float32":
        assert 0.2 < np.mean((want > 0) & (want < 1))  # not all clipped
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        return
    err = np.abs(got - want)[:, 4:-4, 4:-4]
    assert err.max() <= 1e-2 and err.mean() <= 1e-3, (err.max(), err.mean())
    assert set(model.int8_scales_used) == set(sown)
    for key, s in sown.items():
        rel = np.abs(model.int8_scales_used[key].numpy() / s - 1.0).max()
        assert rel <= (0.0 if key == "int8_scale_feat" else 0.03), (key, rel)


# Kernels whose calls the routing decides: the JAX wrapper's name and the
# port's. (JAX's default conv1 is XLA's, the port's ``ops.conv.conv2d``.)
KERNELS = {"conv1_dots_stream": "conv1_stream",
           "conv3x3_tail_emit_stream": "conv3x3_tail_emit_stream",
           "conv3x3_tail_stream": "conv3x3_tail_stream",
           "conv3x3_deint_stream": "conv3x3_stream",
           "tail_macro8_stream": "tail_conv_stream",
           "tail_finish_stream": "tail_finish_stream"}


def _port_calls(monkeypatch, scope, conv1_stream, env) -> list:
    calls = []
    for name in KERNELS.values():
        fn = getattr(FT, name)
        monkeypatch.setattr(FT, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    fields = {} if scope is None else dict(int8_serve=True, int8_scope=scope)
    model, _ = _port("bfloat16", conv1_stream=conv1_stream, **fields)
    with environ(env):
        model(torch.from_numpy(X), res_out=RES_OUT)
    return sorted(calls)


def _jax_calls(monkeypatch, scope, conv1_stream, env) -> list:
    calls = []
    for name, port_name in KERNELS.items():
        fn = getattr(jax_stream, name)
        monkeypatch.setattr(jax_stream, name, lambda *a, _n=port_name,
                            _f=fn, **k: (calls.append(_n), _f(*a, **k))[1])
    fields = {} if scope is None else dict(int8_serve=True, int8_scope=scope)
    _, tree = _port("bfloat16", **fields)
    model = _jax_model("bfloat16", conv1_stream=conv1_stream, **fields)
    with environ(env):
        jax.eval_shape(lambda p, x: model.apply(p, x, res_out=RES_OUT),
                       {"params": tree}, jnp.asarray(X))
    return sorted(calls)


FUSE = {"TUX_FUSE_STREAM": "1"}
# (scope, conv1_stream field, environment) -> the port's calls, which the
# JAX model makes too (the first three are also traced on the JAX side).
ROUTING = [
    (None, True, FUSE, ["conv3x3_tail_emit_stream", "conv3x3_tail_stream"]),
    ("tails", None, {**FUSE, "TUX_CONV1_STREAM": ""},
     ["conv1_stream", "conv3x3_stream", "conv3x3_tail_stream"]),
    ("residual", True, FUSE, ["conv3x3_tail_emit_stream"]),
    ("full", True, FUSE, []),
    (None, None, {}, ["conv3x3_stream", "conv3x3_stream", "tail_conv_stream",
                      "tail_finish_stream"]),
    (None, True, {}, ["conv1_stream", "conv3x3_stream", "conv3x3_stream",
                      "tail_conv_stream", "tail_finish_stream"]),
    (None, True, {"TUX_CONV1_STREAM": "0"},
     ["conv3x3_stream", "conv3x3_stream", "tail_conv_stream",
      "tail_finish_stream"]),
    (None, False, {"TUX_CONV1_STREAM": "1"},
     ["conv1_stream", "conv3x3_stream", "conv3x3_stream", "tail_conv_stream",
      "tail_finish_stream"]),
    (None, None, {"TUX_FUSE_STREAM": "true"},
     ["conv3x3_stream", "conv3x3_stream", "tail_conv_stream",
      "tail_finish_stream"]),
    ("residual", True, {}, ["conv1_stream", "conv3x3_stream",
                            "tail_conv_stream"]),
]
TRACED = 3


@pytest.mark.parametrize("case", range(len(ROUTING)))
def test_routing_mirrors_jax(monkeypatch, case):
    """``TUX_FUSE_STREAM`` is on only at "1"; ``TUX_CONV1_STREAM`` unset
    leaves the field to decide, and any other value but "0" turns conv1's
    kernel on; the fused encoder and the "full" scope take the plain conv1;
    under int8, "residual" fuses only the encoder and "tails" only the
    decoder (fast_transformer.py:514-520, 581-595, 702-706)."""
    scope, conv1_stream, env, want = ROUTING[case]
    assert _port_calls(monkeypatch, scope, conv1_stream, env) == want
    if case < TRACED:
        monkeypatch.undo()
        assert _jax_calls(monkeypatch, scope, conv1_stream, env) == want


def test_fused_route_folds_the_b_tail():
    """The fused decoder takes the folded tail (fast_transformer.py:780-789
    come before the split choice): ``splits_tail`` follows the switch and
    the composed kernels are kept per choice."""
    model, _ = _port("bfloat16")
    with environ({}):
        assert model.splits_tail
        split = model.tail_kernels(2)[1]
    with environ(FUSE):
        assert not model.splits_tail
        folded = model.tail_kernels(2)[1]
    assert split[0][0].shape == (5, 5, 64, 12)
    assert folded[0].shape == (7, 7, 64, 12)
    with environ({}):
        assert model.tail_kernels(2)[1] is split


def test_conv1_stream_field_is_checked():
    with pytest.raises(ValueError, match="conv1_stream"):
        get_model("FastTransformer", device="cpu", conv1_stream="yes",
                  **ROUTE, **SMALL)


FUSE_FIXTURE = os.path.join(DIR, "fuse_stream_x2_bf16.npz")


def fuse_fixture() -> dict:
    with environ(FUSE):
        return jax_fixture(BENCH_ROUTE, BENCH_IN_HW, BENCH_RES_OUT)


def test_fuse_fixture_is_fresh():
    """The committed JAX output equals what the JAX model gives now."""
    assert os.path.getsize(FUSE_FIXTURE) < 300_000
    _assert_fresh(FUSE_FIXTURE, fuse_fixture())


def test_port_on_cpu_matches_fuse_fixture():
    with environ(FUSE):
        _assert_port_matches(FUSE_FIXTURE, BENCH_ROUTE, BENCH_RES_OUT)


if __name__ == "__main__":
    np.savez_compressed(FUSE_FIXTURE, **fuse_fixture())
    print("wrote", FUSE_FIXTURE, os.path.getsize(FUSE_FIXTURE), "bytes")
