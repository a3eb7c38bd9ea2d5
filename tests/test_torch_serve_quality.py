"""FastTransformer's ``serve_quality`` and the serving fields that go with it
(``quality_parts``, ``f32_tail``, ``hi_lo_fin``, ``split_tail``,
``fold_pre``) and their ``TUX_*`` switches, in the port against the JAX model
``_packed_forward`` on the CPU (its Pallas kernels in interpret mode, the
port's wrappers on their plain versions); and the two fixtures chip_smoke.py
holds the routes ``quality`` and ``quality_x4`` to on the card.

At dim 32 (2 blocks, 2 heads), ``compose_tails=True, pallas_serve=True,
attn_impl="xla"`` (the trunk is not what these fields change), bf16, the
same seeded weights on both sides:

- the routing: which kernels a forward calls, with the tails' output dtype
  and the split tail's finish mode, for a matrix of fields, scales and
  switches (``ROUTING``), against the expected calls read off
  fast_transformer.py:467-480, 563-579, 744-902; the first ``TRACED`` are
  also traced on the JAX side (``jax.eval_shape`` with spies on its
  kernels; the fixtures below run the "tails" part at x2 and x4);
- the exact-uint8 conv1 of the "conv1" part against JAX's
  ``conv2d_packed_dots_deint(k_hi_lo=True)`` at f32 (products of bf16
  values, exact in f32; sums in another order), and where the model runs
  it (an f32 input only);
- the engine: under ``serve_quality`` the model gets the f32 frame, and
  ``quality_parts`` reaches the model only with ``serve_quality``.

The routes' numbers against JAX come from the fixtures below (held by the
port on the CPU here, interior max 3e-2, mean 3e-3 as
tests/test_torch_bench_route.py); a JAX forward with Pallas in interpret
mode costs about 20 s, so the field matrix is held by its routing.

The fixtures, at full width (dim 192, 6 blocks, 12 heads) on bench.py's
``quality`` flags (``attn_impl="fused2", serve_quality=True``), 8x16 input,
seed 7, weights from ``seeded_params``, the JAX output in bf16 compute with
f32 tails: tests/fixtures/torch_port/quality_x2_bf16.npz (res_out 12x24:
x2 and the squash, both tails f32, B folded) and quality_x4_bf16.npz (32x64,
x4: the split B tail in "wf" with f32 output). Their port-on-CPU checks
hold those two routes against JAX. Regenerate them with
``PYTHONPATH=. python tests/test_torch_serve_quality.py`` from the repo root.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import transformerupscaler_tpu.ops.conv as jax_conv
import transformerupscaler_tpu.ops.pallas.stream as jax_stream
from test_torch_fixtures import (
    DIR,
    _assert_fresh,
    _assert_port_matches,
    jax_fixture,
)
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.models import fast_transformer as FT
from transformerupscaler_torch.ops.conv import conv2d_uint8_exact
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="xla")
IN_HW, WSEED = (16, 64), 3
ENV = ("TUX_SPLIT_TAIL", "TUX_HILO_FIN", "TUX_FOLD_PRE", "TUX_F32_TAIL",
       "TUX_SERVE_QUALITY", "TUX_PALLAS_PATCH", "TUX_FUSE_STREAM",
       "TUX_CONV1_STREAM")
FIXTURE_ROUTE = dict(attn_impl="fused2", serve_quality=True)
FIXTURES = {"quality_x2": (os.path.join(DIR, "quality_x2_bf16.npz"),
                           (12, 24)),
            "quality_x4": (os.path.join(DIR, "quality_x4_bf16.npz"),
                           (32, 64))}
FIX_HW = (8, 16)


def _x():
    return np.random.default_rng(WSEED).random((1, *IN_HW, 3)).astype(
        np.float32)


def _port(dtype="bfloat16", **fields):
    model = get_model("FastTransformer", device="cpu",
                      dtype=getattr(torch, dtype), **ROUTE, **SMALL, **fields)
    tree = seeded_params(model, WSEED)
    params_from_jax(model, tree)
    return model, tree


def _jax_model(dtype="bfloat16", **fields):
    return jax_get_model("FastTransformer", dtype=jnp.dtype(dtype), **ROUTE,
                         **SMALL, **fields)


def _name(dt) -> str:
    return str(dt).replace("torch.", "").replace("dtype(", "").strip("')")


BASE = ["conv3x3_stream", "conv3x3_stream", "embed_stream",
        "unembed_combine_stream"]
BF, F32 = "bfloat16", "float32"


def _tail(odt):
    """A composed tail on ``tail_conv_stream``: tail A, or the folded B."""
    return f"tail_conv_stream:{odt}"


def _split(odt, mode):
    return f"tail_finish_stream:{odt}:{mode}"


# (label, dtype, fields, environment, scale, the calls, a warning expected)
ROUTING = [
    ("env-hilo-full", BF, {}, {"TUX_HILO_FIN": "full"}, 2,
     BASE + [_tail(BF), _split(BF, "full")], "TUX_HILO_FIN"),
    ("parts-conv1,tails", BF, dict(serve_quality=True,
                                   quality_parts="conv1,tails"), {}, 2,
     BASE + ["conv1_exact", _tail(F32), _tail(F32)], None),
    ("quality-x4", BF, dict(serve_quality=True), {}, 4,
     BASE + [_tail(F32), _split(F32, "wf")], None),
    ("fold_pre-false-f32_tail", BF, dict(fold_pre=False, f32_tail=True), {},
     3, BASE + [_tail(F32)], "TUX_F32_TAIL"),
    ("quality-x2", BF, dict(serve_quality=True), {}, 2,
     BASE + [_tail(F32), _tail(F32)], None),
    ("quality-x3", BF, dict(serve_quality=True), {}, 3,
     BASE + [_tail(F32), _tail(F32)], None),
    ("plain-x3", BF, {}, {}, 3, BASE + [_tail(BF), _split(BF, "off")], None),
    ("plain-x4", BF, {}, {}, 4, BASE + [_tail(BF), _split(BF, "off")], None),
    ("f32_tail", BF, dict(f32_tail=True), {}, 2,
     BASE + [_tail(F32), _split(F32, "off")], None),
    ("parts-squash", BF, dict(serve_quality=True, quality_parts="squash"),
     {}, 2, BASE + [_tail(BF), _tail(BF)], None),
    ("parts-conv1", BF, dict(serve_quality=True, quality_parts="conv1"), {},
     2, BASE + ["conv1_exact", _tail(BF), _tail(BF)], None),
    ("quality-hi_lo_fin-full-x4", BF, dict(serve_quality=True,
                                           hi_lo_fin="full"), {}, 4,
     BASE + [_tail(F32), _split(F32, "full")], None),
    ("f32-model-quality-x4", F32, dict(serve_quality=True), {}, 4,
     BASE + [_tail(F32), _tail(F32)], None),
    ("split_tail-true-quality", BF, dict(serve_quality=True,
                                         split_tail=True), {}, 2,
     BASE + [_tail(F32), _split(F32, "wf")], None),
    ("env-split-1-quality", BF, dict(serve_quality=True),
     {"TUX_SPLIT_TAIL": "1"}, 2, BASE + [_tail(F32), _split(F32, "wf")], None),
    ("env-split-0", BF, dict(split_tail=True), {"TUX_SPLIT_TAIL": "0"}, 2,
     BASE + [_tail(BF), _tail(BF)], None),
    ("env-fold_pre-0", BF, {}, {"TUX_FOLD_PRE": "0"}, 2, BASE + [_tail(BF)],
     None),
    ("env-fold_pre-1", BF, dict(fold_pre=False), {"TUX_FOLD_PRE": "1"}, 2,
     BASE + [_tail(BF), _split(BF, "off")], None),
    ("env-f32_tail", BF, {}, {"TUX_F32_TAIL": "1"}, 2,
     BASE + [_tail(F32), _split(F32, "off")], None),
    ("env-serve_quality", BF, {}, {"TUX_SERVE_QUALITY": "1"}, 2,
     BASE + [_tail(F32), _tail(F32)], None),
    ("env-pallas_patch-embed", BF, {}, {"TUX_PALLAS_PATCH": "embed"}, 2,
     BASE[:3] + [_tail(BF), _split(BF, "off")], None),
    ("env-fuse-quality", BF, dict(serve_quality=True),
     {"TUX_FUSE_STREAM": "1"}, 2,
     ["conv3x3_tail_emit_stream:float32", "conv3x3_tail_stream:float32",
      "embed_stream", "unembed_combine_stream"], None),
    ("env-pallas_patch-none-residual", BF, dict(int8_serve=True,
                                                int8_scope="residual"),
     {"TUX_PALLAS_PATCH": ""}, 2,
     ["conv3x3_stream", _tail(BF), "conv3x3_int8_stream",
      "tail_conv_int8_stream"], None),
    ("int8-tails-quality", BF, dict(serve_quality=True, int8_serve=True,
                                    int8_scope="tails"), {}, 2,
     ["conv3x3_stream", "conv3x3_stream", "embed_stream",
      "unembed_combine_stream", "tail_conv_int8_stream",
      "tail_conv_int8_stream"], None),
]
TRACED = 2


def _set_env(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _port_calls(monkeypatch, dtype, fields, env, scale) -> list:
    calls = []

    def spy(name, fn, kind):
        def wrapped(*a, **k):
            odt = k.get("out_dtype") or a[0].dtype
            calls.append({
                "plain": name,
                "out": f"{name}:{_name(odt)}",
                "finish": f"{name}:{_name(odt)}:{k.get('hi_lo_fin')}",
            }[kind])
            return fn(*a, **k)
        monkeypatch.setattr(FT, name, wrapped)

    for name, kind in (("conv3x3_stream", "plain"), ("embed_stream", "plain"),
                       ("unembed_combine_stream", "plain"),
                       ("conv1_stream", "plain"),
                       ("tail_conv_int8_stream", "plain"),
                       ("conv3x3_int8_stream", "plain"),
                       ("tail_conv_stream", "out"),
                       ("conv3x3_tail_stream", "out"),
                       ("tail_finish_stream", "finish")):
        spy(name, getattr(FT, name), kind)
    exact = FT.conv2d_uint8_exact
    monkeypatch.setattr(FT, "conv2d_uint8_exact", lambda *a, **k: (
        calls.append("conv1_exact"), exact(*a, **k))[1])
    emit = FT.conv3x3_tail_emit_stream
    monkeypatch.setattr(FT, "conv3x3_tail_emit_stream", lambda *a, **k: (
        calls.append(f"conv3x3_tail_emit_stream:"
                     f"{_name(k.get('out_dtype') or a[0].dtype)}"),
        emit(*a, **k))[1])
    model, _ = _port(dtype, **fields)
    _set_env(monkeypatch, env)
    model(torch.from_numpy(_x()), upscale_factor=scale)
    return sorted(calls)


def _jax_spies(monkeypatch, dtype) -> list:
    """Spies on the JAX kernels the serving forward calls; returns the list
    they record into, in ``_port_calls``' terms."""
    calls = []
    dt = _name(jnp.dtype(dtype))

    def spy(mod, name, port, kind):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            odt = _name(jnp.dtype(k["out_dtype"])) if k.get(
                "out_dtype") is not None else dt
            if kind == "finish":
                mode = os.environ.get("TUX_HILO_FIN") or k.get("hi_lo_fin")
                calls.append(f"{port}:{odt}:{mode}")
            elif kind == "out":
                calls.append(f"{port}:{odt}")
            elif kind == "conv1":
                if k.get("k_hi_lo"):
                    calls.append("conv1_exact")
            else:
                calls.append(port)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name, port, kind in (
            ("conv3x3_deint_stream", "conv3x3_stream", "plain"),
            ("conv3x3_packed_stream", "conv3x3_stream", "plain"),
            ("embed_stream", "embed_stream", "plain"),
            ("unembed_combine_stream", "unembed_combine_stream", "plain"),
            ("conv1_dots_stream", "conv1_stream", "plain"),
            ("tail_macro8_stream", "tail_conv_stream", "out"),
            ("conv3x3_tail_stream", "conv3x3_tail_stream", "out"),
            ("conv3x3_tail_emit_stream", "conv3x3_tail_emit_stream", "out"),
            ("tail_finish_stream", "tail_finish_stream", "finish")):
        spy(jax_stream, name, port, kind)
    spy(jax_conv, "conv2d_packed_dots_deint", None, "conv1")
    return calls


def _jax_calls(monkeypatch, dtype, fields, env, scale) -> list:
    calls = _jax_spies(monkeypatch, dtype)
    _, tree = _port(dtype, **fields)
    model = _jax_model(dtype, **fields)
    _set_env(monkeypatch, env)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax.eval_shape(lambda p, x: model.apply(p, x, upscale_factor=scale),
                       {"params": tree}, jnp.asarray(_x()))
    return sorted(calls)


@pytest.mark.parametrize("case", range(len(ROUTING)),
                         ids=[c[0] for c in ROUTING])
def test_quality_routing_mirrors_jax(monkeypatch, case):
    """The kernels a forward calls, the tails' output dtype and the finish
    mode, as JAX routes them: ``serve_quality`` (or TUX_SERVE_QUALITY=1)
    makes the Pallas tails emit f32 under its "tails" part, splits the B
    tail at x4 only with "wf"; "conv1" runs the exact-uint8 conv1 on the f32
    input; ``f32_tail`` / TUX_F32_TAIL emit f32 alone; TUX_SPLIT_TAIL,
    TUX_HILO_FIN (with JAX's warning), TUX_FOLD_PRE and TUX_PALLAS_PATCH
    override their fields; the factored tail warns that f32 tails do not
    reach it."""
    _, dtype, fields, env, scale, want, warn = ROUTING[case]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _port_calls(monkeypatch, dtype, fields, env, scale)
    said = [str(w.message) for w in caught if "TUX_" in str(w.message)]
    assert [m.split("=")[0] for m in said] == ([] if warn is None
                                               else [warn]), said
    assert got == sorted(want)
    if case < TRACED:
        monkeypatch.undo()
        assert _jax_calls(monkeypatch, dtype, fields, env, scale) == got


CONV1_TAILS = dict(serve_quality=True, quality_parts="conv1,tails")


def test_conv1_part_reads_the_f32_input():
    """quality_parts "conv1,tails": on an f32 input conv1 runs as exact
    uint8 values and moves the output; on a bf16 input it is skipped
    (fast_transformer.py:563-564) and the output is the "tails" part's,
    bit for bit."""
    model, _ = _port(serve_quality=True, quality_parts="conv1,tails")
    plain, _ = _port(serve_quality=True)
    x = torch.from_numpy(_x())
    got = model(x, res_out=(24, 96))
    assert got.shape == (1, 24, 96, 3) and torch.isfinite(got).all()
    assert not torch.equal(got, plain(x, res_out=(24, 96)))
    xb = x.bfloat16()
    assert torch.equal(model(xb, res_out=(24, 96)),
                       plain(xb, res_out=(24, 96)))


def test_exact_uint8_conv1_matches_jax():
    """``conv2d_uint8_exact`` against JAX's ``conv2d_packed_dots_deint``
    with ``k_hi_lo=True, pre_scale=1/255`` on the f32 frame of a uint8
    image (bf16(x * 255) exact), f32 out."""
    r = np.random.default_rng(0)
    x = (r.integers(0, 256, (1, 8, 32, 3)) / 255.0).astype(np.float32)
    k = (r.standard_normal((3, 3, 3, 64)) * 0.2).astype(np.float32)
    b = (r.standard_normal(64) * 0.1).astype(np.float32)
    xq = (jnp.asarray(x) * jnp.float32(255.0)).astype(jnp.bfloat16)
    want = jax_conv.conv2d_packed_dots_deint(
        xq.reshape(1, 8, 16, 6), jnp.asarray(k), jnp.asarray(b), relu=True,
        k_hi_lo=True, pre_scale=1.0 / 255.0, out_dtype=jnp.float32)
    want = np.asarray(jax_stream.interleave4(want)).reshape(1, 8, 32, 64)
    got = conv2d_uint8_exact(torch.from_numpy(x), torch.from_numpy(k),
                             torch.from_numpy(b), relu=True,
                             out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    assert np.abs(got - want).max() < np.abs(want).max() * 2.0 ** -20


def test_squash_part_changes_nothing_on_the_cpu():
    """The "squash" part (JAX's squash at Precision.HIGH): the port's f32
    squash is exact already, so "squash" alone serves the folded bf16
    route bit for bit (fast_transformer.py:955-958; quality folds at x2)."""
    x = torch.from_numpy(_x())
    squash, _ = _port(serve_quality=True, quality_parts="squash")
    folded, _ = _port(split_tail=False)
    assert torch.equal(squash(x, res_out=(24, 96)),
                       folded(x, res_out=(24, 96)))


def test_engine_keeps_the_f32_frame_under_serve_quality(monkeypatch,
                                                        tmp_path):
    """Under ``serve_quality`` the engine normalizes a uint8 frame to f32 on
    the device and the model's exact conv1 reads it (JAX infer_lib.py:
    160-162); without it, ``quality_parts`` does not reach the model, as in
    the JAX engine (:58-63), even under TUX_SERVE_QUALITY=1."""
    seen = []
    exact = FT.conv2d_uint8_exact
    monkeypatch.setattr(FT, "conv2d_uint8_exact", lambda x, *a, **k: (
        seen.append(x.dtype), exact(x, *a, **k))[1])
    frame = np.random.default_rng(1).integers(0, 256, (16, 64, 3), np.uint8)
    kw = dict(dtype=torch.bfloat16, device="cpu", root=str(tmp_path),
              quality_parts="conv1,tails", **ROUTE, **SMALL)
    engine = UpscalerEngine("FastTransformer", serve_quality=True, **kw)
    assert engine.model.serve_quality
    assert engine.model.quality_parts == "conv1,tails"
    got = engine.upscale(frame, upscale_factor=2)
    assert seen == [torch.float32]
    x = torch.from_numpy(frame).float()[None] / 255.0
    want = engine.model(x, upscale_factor=2).float().numpy()[0]
    np.testing.assert_array_equal(got, want)
    plain = UpscalerEngine("FastTransformer", **kw)
    assert not plain.model.serve_quality
    assert plain.model.quality_parts == "tails"
    monkeypatch.setenv("TUX_SERVE_QUALITY", "1")
    seen.clear()
    plain.upscale(frame, upscale_factor=2)
    assert seen == []
    other = UpscalerEngine("WindowTransformer", serve_quality=True,
                           device="cpu", root=str(tmp_path))
    assert not other.serve_quality


@pytest.fixture(scope="module")
def jax_quality_fixtures():
    return {name: jax_fixture(FIXTURE_ROUTE, FIX_HW, res_out)
            for name, (_, res_out) in FIXTURES.items()}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_quality_fixture_is_fresh(jax_quality_fixtures, name):
    path, _ = FIXTURES[name]
    assert os.path.getsize(path) < 300_000
    _assert_fresh(path, jax_quality_fixtures[name])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_on_cpu_matches_quality_fixture(name):
    path, res_out = FIXTURES[name]
    _assert_port_matches(path, FIXTURE_ROUTE, res_out)


if __name__ == "__main__":
    for name, (path, res_out) in FIXTURES.items():
        np.savez_compressed(path, **jax_fixture(FIXTURE_ROUTE, FIX_HW,
                                                res_out))
        print("wrote", path, os.path.getsize(path), "bytes")
