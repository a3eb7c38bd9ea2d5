"""FastTransformer at x6 on the serving forward (``compose_tails=True,
pallas_serve=True``) in the port against the JAX model ``_packed_forward``
on the CPU (its Pallas kernels in interpret mode, the port's wrappers on
their plain versions), and the fixture chip_smoke.py holds the route
``fast_x6`` to on the card.

At x6 the composed tails have 3 * 36 = 108 outputs and run as direct convs
(``direct_tails``, fast_transformer.py:445-448): tail A 5x5 64->108 + ReLU,
tail B the folded 7x7 64->108 or, with ``fold_pre=False``, the factored
3x3 64->3 then 5x5 3->108; conv2 and the decoder conv on the stream conv;
the int8 "tails" scope quantizes the direct tails' inputs (``i8dt``), "full"
and "residual" run the 108-output int8 tails as exact int32 products.

At dim 32 (2 blocks, 2 heads), ``attn_impl="xla"`` (the trunk is not what
x6 changes), the same seeded weights on both sides, 8x32 -> 48x192: f32
with the folded B tail and with ``fold_pre=False`` (the factored one), and
in bf16 with dynamic scales the int8 scopes "tails" (the direct int8
tails), "full" (the 108-output int8 tails and the int8 conv2) and
"residual" (the 108-output int8 tail B behind the bf16 image branch and
its 108-output bf16 tail A); bf16 with the folded tail and a squashed
``res_out`` is the fixture's route, below. A JAX forward with Pallas in
interpret mode costs about 10 s here.
Tolerances: f32 on the whole frame at tests/test_parity.py:69's
atol=5e-5, rtol=1e-4; bf16 interior max 3e-2, mean 3e-3; int8 interior
max 1e-2, mean 1e-3, the scales as tests/test_torch_int8_scopes.py holds
them. Each JAX forward runs once per module.

The fixture, tests/fixtures/torch_port/fast_x6_bf16.npz: the bf16 output of
the JAX model at full width (dim 192, 6 blocks, 12 heads) on bench.py's
flags (``attn_impl="fused2"``), 8x16 -> 40x90 (x6, 48x96 squashed), seed
7, weights from ``seeded_params``; its port-on-CPU check holds that route
against JAX at interior max 3e-2, mean 3e-3. Regenerate it with
``PYTHONPATH=. python tests/test_torch_x6.py`` from the repo root.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_fixtures import (
    DIR,
    _assert_fresh,
    _assert_port_matches,
    jax_fixture,
)
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.models import fast_transformer as FT
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="xla")
IN_HW, WSEED = (8, 32), 3
X6 = dict(upscale_factor=6)
# name -> (dtype, extra fields, call)
RUNS = {
    "f32": ("float32", {}, X6),
    "f32-fold_pre_false": ("float32", dict(fold_pre=False), X6),
    **{f"{s}-dynamic": ("bfloat16", dict(int8_serve=True, int8_scope=s), X6)
       for s in ("tails", "full", "residual")},
}
BEFORE_TRUNK = {"int8_scale_feat1", "int8_scale_feat"}
FIXTURE = os.path.join(DIR, "fast_x6_bf16.npz")
FIXTURE_ROUTE = dict(attn_impl="fused2")
FIX_HW, FIX_RES_OUT = (8, 16), (40, 90)


def _x():
    return np.random.default_rng(WSEED).random((1, *IN_HW, 3)).astype(
        np.float32)


def _port(dtype, **fields):
    model = get_model("FastTransformer", device="cpu",
                      dtype=getattr(torch, dtype), **ROUTE, **SMALL, **fields)
    tree = seeded_params(model, WSEED)
    params_from_jax(model, tree)
    return model, tree


@pytest.fixture(scope="module")
def jax_runs():
    """name -> (JAX output, its sown scales)."""
    runs = {}
    for name, (dtype, fields, call) in RUNS.items():
        _, tree = _port(dtype, **fields)
        jm = jax_get_model("FastTransformer", dtype=jnp.dtype(dtype),
                           **ROUTE, **SMALL, **fields)
        y, inter = jm.apply({"params": tree}, jnp.asarray(_x()), **call,
                            mutable=["intermediates"])
        runs[name] = (np.asarray(y, np.float32),
                      {k: np.asarray(v[0])
                       for k, v in inter.get("intermediates", {}).items()})
    return runs


@pytest.mark.parametrize("name", list(RUNS))
def test_x6_matches_jax(jax_runs, name):
    dtype, fields, call = RUNS[name]
    want, sown = jax_runs[name]
    model, _ = _port(dtype, **fields)
    assert model.route(6).direct_tails
    got = model(torch.from_numpy(_x()), **call).float().numpy()
    assert got.shape == want.shape
    assert got.shape[1:3] == (48, 192)
    if dtype == "float32":
        assert 0.2 < np.mean((want > 0) & (want < 1))  # not all clipped
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        return
    err = np.abs(got - want)[:, 6:-6, 6:-6]
    limit = (1e-2, 1e-3) if sown else (3e-2, 3e-3)
    assert err.max() <= limit[0] and err.mean() <= limit[1], (err.max(),
                                                               err.mean())
    assert set(model.int8_scales_used) == set(sown)
    for key, s in sown.items():
        rel = np.abs(model.int8_scales_used[key].numpy() / s - 1.0).max()
        assert rel <= (0.0 if key in BEFORE_TRUNK else 0.03), (key, rel)


def test_x6_scopes_quantize_what_jax_quantizes(jax_runs):
    """At x6 on the Pallas path "tails" quantizes the direct tails' inputs;
    "full" and "residual" as at x2 (their embed and unembed stay bf16)."""
    want = {"tails": {"feat", "dec"},
            "full": {"feat1", "feat", "combined", "dec"},
            "residual": {"combined", "dec"}}
    for scope, names in want.items():
        sown = jax_runs[f"{scope}-dynamic"][1]
        assert {k[len("int8_scale_"):] for k in sown} == names


WRAPPERS = ("conv1_stream", "conv3x3_stream", "tail_conv_stream",
            "embed_stream", "unembed_combine_stream", "tail_finish_stream",
            "conv3x3_int8_stream", "tail_conv_int8_stream",
            "conv3x3_tail_stream", "conv3x3_tail_emit_stream")


def _calls(monkeypatch, model, **call):
    calls = []
    for name in WRAPPERS:
        fn = getattr(FT, name)
        monkeypatch.setattr(FT, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    out = model(torch.from_numpy(_x()), **call)
    monkeypatch.undo()
    return sorted(calls), out


def test_x6_routes_as_jax(monkeypatch):
    """What x6 runs on the card's kernels: conv2 and the decoder conv on the
    stream conv, the patch kernels (the trunk is "xla" here), no tail kernel
    (fast_transformer.py:445-448, 617-619, 914-918). The split tail, the
    f32 tails and the fused kernels do not apply (:850-851, 515-516,
    705): ``split_tail=True``, ``f32_tail``, ``TUX_F32_TAIL``,
    ``TUX_SPLIT_TAIL``, ``TUX_FUSE_STREAM`` and ``TUX_CONV1_STREAM`` change
    nothing, bit for bit; "full" runs the 3x3s on the int8 conv, "residual"
    the decoder conv only, quantizing ``combined`` and ``dec`` (:373-375,
    903-924)."""
    base, _ = _port("bfloat16")
    calls, want = _calls(monkeypatch, base, **X6)
    assert calls == ["conv3x3_stream", "conv3x3_stream", "embed_stream",
                     "unembed_combine_stream"]
    assert base.route(6).b_tail == "fold" and base.route(2).b_tail == "split"
    for fields, env in ((dict(split_tail=True), {}), (dict(f32_tail=True), {}),
                        (dict(serve_quality=True), {}),
                        ({}, {"TUX_F32_TAIL": "1", "TUX_SPLIT_TAIL": "1",
                              "TUX_FUSE_STREAM": "1",
                              "TUX_CONV1_STREAM": "1"})):
        model, _ = _port("bfloat16", conv1_stream=True, **fields)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got_calls, got = _calls(monkeypatch, model, **X6)
        assert got_calls == calls, (fields, env)
        assert torch.equal(got, want), (fields, env)
    full, _ = _port("bfloat16", int8_serve=True, int8_scope="full")
    assert _calls(monkeypatch, full, **X6)[0] == [
        "conv3x3_int8_stream", "conv3x3_int8_stream", "embed_stream",
        "unembed_combine_stream"]
    residual, _ = _port("bfloat16", int8_serve=True, int8_scope="residual")
    calls, _ = _calls(monkeypatch, residual, **X6)
    assert calls == ["conv3x3_int8_stream", "conv3x3_stream",
                     "embed_stream", "unembed_combine_stream"]
    assert set(residual.int8_scales_used) == {"int8_scale_combined",
                                              "int8_scale_dec"}


def test_x6_fold_pre_switch(monkeypatch):
    """``TUX_FOLD_PRE=0`` is ``fold_pre=False`` (the factored tail), and
    "1" over ``fold_pre=False`` folds again; the int8 scopes force the
    fold (fast_transformer.py:746-749)."""
    x = torch.from_numpy(_x())
    folded, _ = _port("float32")
    factored, _ = _port("float32", fold_pre=False)
    assert factored.route(6).b_tail == "factored"
    want_fold, want_fact = folded(x, **X6), factored(x, **X6)
    assert not torch.equal(want_fold, want_fact)
    monkeypatch.setenv("TUX_FOLD_PRE", "0")
    assert torch.equal(folded(x, **X6), want_fact)
    monkeypatch.setenv("TUX_FOLD_PRE", "1")
    assert torch.equal(factored(x, **X6), want_fold)
    monkeypatch.setenv("TUX_FOLD_PRE", "0")
    tails, _ = _port("bfloat16", int8_serve=True, int8_scope="tails")
    assert tails.route(6).b_tail == "fold"


@pytest.fixture(scope="module")
def jax_x6_fixture():
    return jax_fixture(FIXTURE_ROUTE, FIX_HW, FIX_RES_OUT)


def test_x6_fixture_is_fresh(jax_x6_fixture):
    assert os.path.getsize(FIXTURE) < 300_000
    _assert_fresh(FIXTURE, jax_x6_fixture)


def test_port_on_cpu_matches_x6_fixture():
    _assert_port_matches(FIXTURE, FIXTURE_ROUTE, FIX_RES_OUT)


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **jax_fixture(FIXTURE_ROUTE, FIX_HW,
                                               FIX_RES_OUT))
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")
