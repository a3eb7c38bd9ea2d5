"""FastTransformer's all-XLA packed serving path (``packed_serve`` or
``int8_serve`` without ``pallas_serve``: JAX ``_packed_forward`` with
``use_pallas = False``, fast_transformer.py:333-961) in the port against the
JAX model on the CPU, and the two fixtures chip_smoke.py holds its routes
``xla_packed`` and ``int8_full_xla`` to on the card.

8x16 -> 12x24 (x2 with the squash; one window), the same seeded weights
on both sides (seed 7): bf16 and f32; the int8 scopes "full", "residual"
and "tails", dynamic and static (bench.py's scales: the JAX dynamic pass's,
times 1.1; "tails" quantizes nothing here, so its static form is checked
on the port alone). The fixtures' runs (bf16, and "full" dynamic then
static) are at full width (dim 192, 6 blocks, 12 heads, a tokens scale 192
wide); the others at dim 32 (2 blocks, 2 heads). No JAX forward here runs
a Pallas kernel. Each runs once per module. (``TUX_PALLAS_PATCH``, which
puts these patch products on the Pallas path, is routed in
tests/test_torch_serve_quality.py.)

Tolerances: f32 on the whole frame at tests/test_parity.py:69's atol=5e-5,
rtol=1e-4 (the same function, each conv or product rounded where XLA rounds
it); bf16 interior max 3e-2, mean 3e-3 (tests/test_torch_bench_route.py);
int8 interior max 1.5e-2, mean 2.5e-3 (chip_smoke.py's ``INT8_LIMIT``,
tests/test_torch_int8_serve.py at this width); scales taken before the
trunk equal, after it within 3% or 1% of the tensor's largest (a channel
whose values are all small, over two tokens here, moves by the trunk's
absolute bf16 error). The int8 patch GEMMs, the int8 3x3 conv and the int8
tails (up to 48 outputs on rows 8 and 9's plain versions, beyond on
``conv2d_int8_mm``) equal the JAX functions bit for bit.

The fixtures, the JAX outputs of two of those runs:

- tests/fixtures/torch_port/xla_packed_x2_bf16.npz: ``compose_tails=True,
  packed_serve=True, attn_impl="xla"`` (what JAX's ``--fast`` builds off a
  TPU);
- tests/fixtures/torch_port/int8_full_xla_x2_bf16.npz: bench.py's
  ``int8_full`` as it builds it (``pallas_serve=False``, ``attn_impl="xla"``),
  bench.py's static scales, the tokens' 192 wide.

Regenerate them with ``PYTHONPATH=. python tests/test_torch_packed_xla.py``
from the repo root.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_fixtures import DIR, SEED, _assert_fresh
from transformerupscaler_tpu.ops.conv import (
    conv2d_int8 as jax_conv2d_int8,
    conv2d_packed_int8,
    conv2d_tail_packed_int8,
    tail_block,
)
from transformerupscaler_tpu.ops.patch import (
    patch_embed_packed_int8,
    patch_unembed_packed_int8,
)
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.kernels import stream as S
from transformerupscaler_torch.models.fast_transformer import INT8_TENSORS
from transformerupscaler_torch.ops import quant as Q
from transformerupscaler_torch.ops.conv import conv2d_int8_mm
from transformerupscaler_torch.ops.patch import (
    patch_embed_int8,
    patch_unembed_int8,
)
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

XLA = dict(compose_tails=True, packed_serve=True, attn_impl="xla")
INT8_FULL_XLA = dict(compose_tails=True, int8_serve=True, int8_scope="full",
                     pallas_serve=False, attn_impl="xla")
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
XLA_SMALL = dict(XLA, **SMALL)
IN_HW, RES_OUT = (8, 16), (12, 24)
SCOPES = ("full", "residual", "tails")
# name -> (dtype, fields, environment, static scales from the run named);
# the fixtures' runs at full width, the others at SMALL.
RUNS = {
    "bf16": ("bfloat16", XLA, {}, None),
    "bf16-small": ("bfloat16", XLA_SMALL, {}, None),
    "f32": ("float32", XLA_SMALL, {}, None),
    "full-dynamic": ("bfloat16", dict(XLA, int8_serve=True,
                                      int8_scope="full"), {}, None),
    **{f"{s}-dynamic": ("bfloat16", dict(XLA_SMALL, int8_serve=True,
                                         int8_scope=s), {}, None)
       for s in ("residual", "tails")},
    "full-static": ("bfloat16", INT8_FULL_XLA, {}, "full-dynamic"),
    "residual-static": ("bfloat16", dict(XLA_SMALL, int8_serve=True,
                                         int8_scope="residual"), {},
                        "residual-dynamic"),
}
BEFORE_TRUNK = ("feat1", "feat")
INT8_LIMIT = (1.5e-2, 2.5e-3)
# fixture -> (file, the run it holds)
FIXTURES = {"xla_packed": (os.path.join(DIR, "xla_packed_x2_bf16.npz"),
                           "bf16"),
            "int8_full_xla": (os.path.join(DIR, "int8_full_xla_x2_bf16.npz"),
                              "full-static")}


@contextlib.contextmanager
def environ(values: dict):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _x():
    return np.random.default_rng(SEED).random((1, *IN_HW, 3)).astype(
        np.float32)


def _dim(fields) -> int:
    return fields.get("transformer_dim", 192)


def _port(dtype, fields, scales=None):
    model = get_model("FastTransformer", device="cpu",
                      dtype=getattr(torch, dtype), int8_scales=scales,
                      **fields)
    tree = seeded_params(model, SEED)
    params_from_jax(model, tree)
    return model, tree


def bench_scales(sown: dict) -> tuple:
    """bench.py's static scales (bench.py:100-108) from sown scales."""
    return tuple(tuple((np.asarray(sown[f"int8_scale_{n}"], np.float64)
                        * 1.1).tolist())
                 if f"int8_scale_{n}" in sown else (1.0,)
                 for n in INT8_TENSORS)


def jax_run(name, runs) -> tuple:
    """(JAX output, its sown scales, the static scales or None) of run
    ``name``; a static run takes its scales from ``runs``."""
    dtype, fields, env, base = RUNS[name]
    scales = None if base is None else bench_scales(runs[base][1])
    _, tree = _port(dtype, fields, scales)
    jm = jax_get_model("FastTransformer", dtype=jnp.dtype(dtype),
                       int8_scales=scales, **fields)
    with environ(env):
        y, inter = jm.apply({"params": tree}, jnp.asarray(_x()),
                            res_out=RES_OUT, mutable=["intermediates"])
    sown = {k: np.asarray(v[0])
            for k, v in inter.get("intermediates", {}).items()}
    return np.asarray(y, np.float32), sown, scales


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for name in RUNS:
        runs[name] = jax_run(name, runs)
    return runs


def _check_scales(used: dict, sown: dict, static: bool):
    assert set(used) == set(sown)
    for key, w in sown.items():
        g = used[key].numpy() if hasattr(used[key], "numpy") else np.asarray(
            used[key])
        if static or key[len("int8_scale_"):] in BEFORE_TRUNK:
            assert np.abs(g / w - 1.0).max() <= 1e-6, key
        else:
            assert (np.abs(g - w) <= np.maximum(
                0.03 * w, 0.01 * w.max())).all(), (key, g, w)


@pytest.mark.parametrize("name", list(RUNS))
def test_packed_xla_matches_jax(jax_runs, name):
    dtype, fields, env, _ = RUNS[name]
    want, sown, scales = jax_runs[name]
    model, _ = _port(dtype, fields, scales)
    assert model.route(2).pallas is fields.get("pallas_serve", False)
    with environ(env):
        got = model(torch.from_numpy(_x()), res_out=RES_OUT).float().numpy()
    assert got.shape == want.shape == (1, *RES_OUT, 3)
    if dtype == "float32":
        assert 0.2 < np.mean((want > 0) & (want < 1))  # not all clipped
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        return
    err = np.abs(got - want)[:, 4:-4, 4:-4]
    limit = INT8_LIMIT if sown else (3e-2, 3e-3)
    assert err.max() <= limit[0] and err.mean() <= limit[1], (err.max(),
                                                               err.mean())
    _check_scales(model.int8_scales_used, sown, scales is not None)


def test_scopes_quantize_what_jax_quantizes(jax_runs):
    """Off the Pallas path "full" quantizes the tokens too (one scale per
    token channel), "residual" keeps the image branch in bf16 and "tails"
    quantizes nothing: it serves the plain bf16 path
    (fast_transformer.py:373-375, 488-493)."""
    want = {"full": {"feat1", "feat", "combined", "dec", "tokens"},
            "residual": {"feat", "combined", "dec", "tokens"},
            "tails": set()}
    for scope in SCOPES:
        name = f"{scope}-dynamic"
        sown = jax_runs[name][1]
        assert {k[len("int8_scale_"):] for k in sown} == want[scope]
        dim = _dim(RUNS[name][1])
        assert len(sown.get("int8_scale_tokens", np.zeros(dim))) == dim
    np.testing.assert_array_equal(jax_runs["tails-dynamic"][0],
                                  jax_runs["bf16-small"][0])
    bf16, _ = _port("bfloat16", XLA_SMALL)
    x = torch.from_numpy(_x())
    want = bf16(x, res_out=RES_OUT)
    # With static scales too (placeholders: the scope reads none).
    for scales in (None, ((1.0,),) * 5):
        tails, _ = _port("bfloat16", dict(XLA_SMALL, int8_serve=True,
                                          int8_scope="tails"), scales)
        assert torch.equal(tails(x, res_out=RES_OUT), want)
        assert tails.int8_scales_used == {}


def test_xla_path_runs_no_kernel_but_rows_8_and_9(monkeypatch):
    """The all-XLA path calls no stream kernel wrapper but the int8 3x3 conv
    and the int8 tail (JAX's ``conv2d_packed_int8`` and
    ``conv2d_tail_packed_int8``), and those only under "full" / "residual"."""
    from transformerupscaler_torch.models import fast_transformer as FT

    calls = []
    for name in ("conv1_stream", "conv3x3_stream", "tail_conv_stream",
                 "embed_stream", "unembed_combine_stream",
                 "tail_finish_stream", "conv3x3_int8_stream",
                 "tail_conv_int8_stream", "conv3x3_tail_stream",
                 "conv3x3_tail_emit_stream"):
        fn = getattr(FT, name)
        monkeypatch.setattr(FT, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x = torch.from_numpy(_x())
    want = {None: [], "tails": [], "residual": [
        "conv3x3_int8_stream", "tail_conv_int8_stream"], "full": [
        "conv3x3_int8_stream", "conv3x3_int8_stream",
        "tail_conv_int8_stream", "tail_conv_int8_stream"]}
    for scope, names in want.items():
        fields = XLA_SMALL if scope is None else dict(
            XLA_SMALL, int8_serve=True, int8_scope=scope)
        model, _ = _port("bfloat16", fields)
        calls.clear()
        model(x, res_out=RES_OUT)
        assert sorted(calls) == names, scope


def _jt(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("d", [192])
def test_int8_patch_gemms_bit_for_bit(d):
    """``patch_embed_int8`` / ``patch_unembed_int8`` equal JAX's
    ``patch_embed_packed_int8`` / ``patch_unembed_packed_int8`` bit for bit
    (f32 and bf16 out; a zero weight column takes the scale 1)."""
    r = np.random.default_rng(d)
    xq = r.integers(-127, 128, (2, 16, 32, 64)).astype(np.int8)
    s = (r.random(64) * 0.05 + 1e-3).astype(np.float32)
    ke = (r.standard_normal((8, 8, 64, d)) * 0.05).astype(np.float32)
    ke[..., 3] = 0.0
    be = r.standard_normal(d).astype(np.float32)
    tq = r.integers(-127, 128, (2, 2, 4, d)).astype(np.int8)
    ts = (r.random(d) * 0.05 + 1e-3).astype(np.float32)
    ku = (r.standard_normal((d, 8, 8, 64)) * 0.05).astype(np.float32)
    ku[..., 5] = 0.0
    bu = r.standard_normal(64).astype(np.float32)
    t = torch.from_numpy
    for odt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(patch_embed_packed_int8(
            _jt(xq.reshape(2, 16, 16, 128)), s, _jt(ke), _jt(be),
            out_dtype=jdt).astype(jnp.float32))
        got = patch_embed_int8(t(xq), t(s), t(ke), t(be), odt)
        np.testing.assert_array_equal(got.float().numpy(), want)
        want = np.asarray(patch_unembed_packed_int8(
            _jt(tq), ts, _jt(ku), _jt(bu), out_dtype=jdt).astype(
            jnp.float32)).reshape(2, 16, 32, 64)
        got = patch_unembed_int8(t(tq), t(ts), t(ku), t(bu), odt)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("k,co,relu", [(3, 64, True), (5, 12, True),
                                       (7, 12, False), (7, 48, False),
                                       (5, 108, True)])
def test_int8_convs_compute_the_xla_functions(k, co, relu):
    """The all-XLA path's int8 convs on the port's routes: the 3x3 on row
    8's plain version and the tails up to 48 outputs on row 9's equal
    JAX's ``conv2d_packed_int8`` / ``conv2d_tail_packed_int8`` bit for bit;
    wider tails (x6) on ``conv2d_int8_mm`` equal those and JAX's direct
    ``conv2d_int8``."""
    r = np.random.default_rng(k * co)
    xq = r.integers(-127, 128, (1, 16, 32, 64)).astype(np.int8)
    s = (r.random(64) * 0.05 + 1e-3).astype(np.float32)
    kern = (r.standard_normal((k, k, 64, co)) * 0.05).astype(np.float32)
    bias = r.standard_normal(co).astype(np.float32)
    t = torch.from_numpy
    kq, ks = Q.fold_conv_kernel(t(kern), t(s))
    xp = _jt(xq.reshape(1, 16, 16, 128))
    for odt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        if k == 3:
            want = conv2d_packed_int8(xp, _jt(kern), s, _jt(bias),
                                      relu=relu, out_dtype=jdt)
            got = S.conv3x3_int8_plain(t(xq), kq, ks, t(bias), relu, odt)
        else:
            want = conv2d_tail_packed_int8(xp, _jt(kern), s, _jt(bias),
                                           relu=relu, out_dtype=jdt,
                                           block=tail_block(co, 32))
            plain = (S.tail_conv_int8_plain if co <= 48 else conv2d_int8_mm)
            got = plain(t(xq), kq, ks, t(bias), relu=relu, out_dtype=odt)
        want = np.asarray(want.astype(jnp.float32)).reshape(1, 16, 32, co)
        np.testing.assert_array_equal(got.float().numpy(), want)
        if k > 3:
            direct = np.asarray(jax_conv2d_int8(
                _jt(xq), _jt(kern), s, _jt(bias), padding=(k - 1) // 2,
                relu=relu, out_dtype=jdt).astype(jnp.float32))
            np.testing.assert_array_equal(
                conv2d_int8_mm(t(xq), kq, ks, t(bias), relu=relu,
                               out_dtype=odt).float().numpy(), direct)


def test_tokens_scale_width_is_checked():
    """A static tokens scale is ``transformer_dim`` wide, 64 for the
    others."""
    model, _ = _port("bfloat16", dict(XLA, int8_serve=True,
                                      int8_scope="full"),
                     ((1.0,) * 64,) * 5)
    with pytest.raises(ValueError, match="tokens needs 192 channel scales"):
        model(torch.from_numpy(_x()), res_out=RES_OUT)


def fixture_content(name, runs) -> dict:
    """What fixture ``name`` holds: the seed, the input, the JAX output,
    res_out and, for the int8 route, bench.py's static scales."""
    y, _, scales = runs[FIXTURES[name][1]]
    extra = {} if scales is None else {
        f"scale_{n}": np.asarray(s, np.float64)
        for n, s in zip(INT8_TENSORS, scales)}
    return dict(seed=np.int64(SEED), x=_x(), y=y,
                res_out=np.asarray(RES_OUT, np.int64), **extra)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_xla_fixture_is_fresh(jax_runs, name):
    path = FIXTURES[name][0]
    assert os.path.getsize(path) < 100_000
    _assert_fresh(path, fixture_content(name, jax_runs))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_engine_calibrates_and_serves_as_jax(jax_runs, name):
    """The port's engine on the fixture's route and weights: bench.py's
    calibration (``calibrate_int8(margin=1.1, floor_frac=0.0)``) gives the
    JAX scales, the tokens' 192 wide, and serving with them the JAX
    output."""
    dtype, fields, _, base = RUNS[FIXTURES[name][1]]
    want, sown, scales = jax_runs[FIXTURES[name][1]]
    engine = UpscalerEngine("FastTransformer", params=_port(dtype,
                                                            fields)[1],
                            dtype=torch.bfloat16, device="cpu", **fields)
    limit = (3e-2, 3e-3)
    if base is not None:
        got = engine.calibrate_int8(_x(), res_out=RES_OUT, margin=1.1,
                                    floor_frac=0.0)
        assert len(got[INT8_TENSORS.index("tokens")]) == 192
        dyn = jax_runs[base][1]
        _check_scales({f"int8_scale_{n}": np.asarray(s) / 1.1
                       for n, s in zip(INT8_TENSORS, got)
                       if f"int8_scale_{n}" in dyn}, dyn, False)
        limit = INT8_LIMIT
    out = engine.upscale(_x(), res_out=RES_OUT)
    assert out.shape == want.shape
    err = np.abs(out - want)[:, 4:-4, 4:-4]
    assert err.max() <= limit[0] and err.mean() <= limit[1], (err.max(),
                                                               err.mean())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_on_cpu_matches_xla_fixture(name):
    """The check chip_smoke.py makes on the card, here with the plain
    versions: the model with the file's scales against its output."""
    path, run = FIXTURES[name]
    with np.load(path) as f:
        x, y, seed = f["x"], f["y"], int(f["seed"])
        scales = (tuple(tuple(f[f"scale_{n}"].tolist())
                        for n in INT8_TENSORS) if "scale_feat" in f.files
                  else None)
    model = get_model("FastTransformer", device="cpu", dtype=torch.bfloat16,
                      int8_scales=scales, **RUNS[run][1])
    params_from_jax(model, seeded_params(model, seed))
    got = model(torch.from_numpy(x), res_out=RES_OUT).float().numpy()
    err = np.abs(got - y)[:, 4:-4, 4:-4]
    limit = INT8_LIMIT if scales else (3e-2, 3e-3)
    assert err.max() <= limit[0] and err.mean() <= limit[1], (err.max(),
                                                               err.mean())


if __name__ == "__main__":
    runs = {}
    for name in ("bf16", "full-dynamic", "full-static"):
        runs[name] = jax_run(name, runs)
    for name, (path, _) in FIXTURES.items():
        np.savez_compressed(path, **fixture_content(name, runs))
        print("wrote", path, os.path.getsize(path), "bytes")
