"""FastTransformer's int8 serving scopes ("tails", "residual", "full") in the
port against the JAX model ``_packed_forward`` with ``pallas_serve=True``,
on the CPU: the JAX Pallas kernels in interpret mode, the port's wrappers on
their plain versions.

At a small width (dim 32, 2 blocks, 2 heads: the ``SMALL`` config of
tests/test_torch_int8_trunk.py), bf16, 16x128 -> 24x192 (a 2 x 16 token
grid: two windows), each scope with dynamic scales and with static scales
(made the way bench.py makes them: the JAX dynamic pass's scales times
1.1), the tails scope under both ``TUX_INT8_TAIL`` values, and the full
scope with the int8 trunk (bench.py's ``int8_full_trunk``). Each JAX
forward runs once per module.

Tolerance. The two sides quantize the same way bit for bit
(tests/test_torch_int8_convs.py), but a bf16 value that rounds the other way
before a quantize (the convs and the trunk sum in other orders) can land on
the neighbouring int8 value, one step of about 1/127 of its channel's
maximum. Measured: interior max abs 0.0049, mean 6.2e-4 at outputs of about
0.09 (all scopes, both kinds of scales); bounds max <= 1e-2, mean <= 1e-3.
A dynamic scale taken after the trunk (``combined``, ``dec``) differs from
JAX's by up to 1.3% for the same reason (measured); bound 3%. The scales of
``feat1`` and ``feat``, taken before any such sum, are equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.models.fast_transformer import INT8_TENSORS
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
SCOPES = ("tails", "residual", "full")
IN_HW, RES_OUT, SEED = (16, 128), (24, 192), 3
SCALED_FIRST = {"feat1", "feat"}


def bench_scales(sown: dict) -> tuple:
    """bench.py's static scales (bench.py:100-108) from sown scales."""
    return tuple(tuple((np.asarray(sown[f"int8_scale_{n}"], np.float64)
                        * 1.1).tolist())
                 if f"int8_scale_{n}" in sown else (1.0,)
                 for n in INT8_TENSORS)


def _port(scope, scales=None, **extra):
    model = get_model("FastTransformer", device="cpu", dtype=torch.bfloat16,
                      int8_serve=True, int8_scope=scope, int8_scales=scales,
                      **ROUTE, **SMALL, **extra)
    tree = seeded_params(model, SEED)
    params_from_jax(model, tree)
    return model, tree


def _x():
    return np.random.default_rng(SEED).random((1, *IN_HW, 3)).astype(
        np.float32)


def _jax(scope, tree, scales=None, **extra):
    jm = jax_get_model("FastTransformer", dtype=jnp.bfloat16,
                       int8_serve=True, int8_scope=scope, int8_scales=scales,
                       **ROUTE, **SMALL, **extra)
    y, inter = jm.apply({"params": tree}, jnp.asarray(_x()), res_out=RES_OUT,
                        mutable=["intermediates"])
    sown = {k: np.asarray(v[0]) for k, v in inter["intermediates"].items()}
    return np.asarray(y, np.float32), sown


@pytest.fixture(scope="module")
def jax_runs():
    """(scope, kind) -> (JAX output, its sown scales, the static scales or
    None): kinds "dynamic" and "static" for each scope, and two variants of
    the static route: the tails scope with TUX_INT8_TAIL=pallas, the full
    scope with the int8 trunk (bench.py's ``int8_full_trunk``)."""
    _, tree = _port("tails")  # the same seeded weights for every scope
    runs = {}
    for scope in SCOPES:
        y, sown = _jax(scope, tree)
        scales = bench_scales(sown)
        runs[scope, "dynamic"] = (y, sown, None)
        runs[scope, "static"] = (*_jax(scope, tree, scales), scales)
    full = runs["full", "static"][2]
    runs["full", "static_int8_trunk"] = (
        *_jax("full", tree, full, int8_trunk=True), full)
    saved = os.environ.get("TUX_INT8_TAIL")
    os.environ["TUX_INT8_TAIL"] = "pallas"
    try:
        tails = runs["tails", "static"][2]
        runs["tails", "static_pallas_tail"] = (*_jax("tails", tree, tails),
                                               tails)
    finally:
        if saved is None:
            del os.environ["TUX_INT8_TAIL"]
        else:
            os.environ["TUX_INT8_TAIL"] = saved
    return runs


CASES = [(s, k) for s in SCOPES for k in ("dynamic", "static")] + [
    ("tails", "static_pallas_tail"), ("full", "static_int8_trunk")]


@pytest.mark.parametrize("scope,kind", CASES,
                         ids=[f"{s}-{k}" for s, k in CASES])
def test_int8_scope_matches_jax(jax_runs, scope, kind):
    want, sown, scales = jax_runs[scope, kind]
    extra = dict(int8_trunk=True) if kind.endswith("int8_trunk") else {}
    model, _ = _port(scope, scales, **extra)
    got = model(torch.from_numpy(_x()), res_out=RES_OUT).float().numpy()
    assert got.shape == want.shape == (1, *RES_OUT, 3)
    err = np.abs(got - want)[:, 4:-4, 4:-4]
    assert err.max() <= 1e-2 and err.mean() <= 1e-3, (err.max(), err.mean())
    assert set(model.int8_scales_used) == set(sown)
    for name, s in sown.items():
        mine = model.int8_scales_used[name].numpy()
        rel = np.abs(mine / s - 1.0).max()
        if scales is not None or name[len("int8_scale_"):] in SCALED_FIRST:
            assert rel == 0.0, (name, rel)
        else:
            assert rel <= 0.03, (name, rel)


def test_scopes_quantize_what_jax_quantizes(jax_runs):
    """The tensors each scope quantizes, by their ``sow`` names."""
    want = {"tails": {"feat", "dec"}, "residual": {"combined", "dec"},
            "full": {"feat1", "feat", "combined", "dec"}}
    for scope in SCOPES:
        sown = jax_runs[scope, "dynamic"][1]
        assert {k[len("int8_scale_"):] for k in sown} == want[scope]


@pytest.mark.parametrize("split_tail", [None, True])
def test_int8_serve_folds_the_b_tail(split_tail):
    """Under int8_serve branch B is always the folded tail, whatever
    ``split_tail`` says (fast_transformer.py:747-749); without it a bf16
    model splits."""
    for scope in SCOPES:
        m, _ = _port(scope, split_tail=split_tail)
        assert not m.splits_tail
        (_, _), kb = m.tail_kernels(2)
        assert kb[0].shape == (7, 7, 64, 12)
    plain = get_model("FastTransformer", device="cpu", dtype=torch.bfloat16,
                      split_tail=split_tail, **ROUTE, **SMALL)
    assert plain.splits_tail


def test_int8_fields_are_checked():
    """The registry takes ``int8_serve`` in every scope; an unknown scope,
    a scale tuple of the wrong length and the placeholder where the scope
    quantizes raise; ``int8_mlp`` is served with it (its blocks take the
    field)."""
    for scope in SCOPES:
        m = get_model("FastTransformer", device="cpu", int8_serve=True,
                      int8_scope=scope, **ROUTE, **SMALL)
        assert m.int8_serve and m.int8_scope == scope
    with pytest.raises(ValueError, match="int8_scope"):
        get_model("FastTransformer", device="cpu", int8_serve=True,
                  int8_scope="tokens", **SMALL)
    with pytest.raises(ValueError, match="int8_scales"):
        get_model("FastTransformer", device="cpu", int8_serve=True,
                  int8_scales=((1.0,),) * 4, **SMALL)
    m = get_model("FastTransformer", device="cpu", int8_serve=True,
                  int8_mlp=True, **SMALL)
    assert m.int8_mlp and all(b.int8_mlp for b in m.blocks)
    model, _ = _port("tails", ((1.0,),) * 5)
    with pytest.raises(ValueError, match="feat needs 64"):
        model(torch.from_numpy(_x()), res_out=RES_OUT)
