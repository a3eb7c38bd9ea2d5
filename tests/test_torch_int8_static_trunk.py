"""The fused trunk's static int8 mode (JAX ``fused_window_trunk_v2(...,
int8_acts=<four per-channel scale stacks>)``, the ``int8_gemms=True`` body
of trunk2.py:182-185) and the block calibration that feeds it (JAX
``WindowBlock(calib_trunk_int8=True)``), on the CPU, where the wrapper
computes its plain version, against the JAX package:

- ``ops.quant.static_gemm_weights`` bit for bit against
  ``trunk2.quantize_gemm_weights`` and the activation quantize of
  trunk2.py:182;
- ``models.common.trunk_int8_scales`` against the maxima the JAX blocks sow,
  at f32 and at bf16 (the qkv bias promotion of common.py:104-111);
- the plain static trunk against the JAX kernel in Pallas interpret mode
  with the calibrated scales and the constant scales 4.0 (which clips) and
  16.0 of ``test_trunk_int8_calibrated_scales`` /
  ``test_fused_trunk_v2_int8_gemms_close_to_f32``: 8 windows of 64 tokens,
  C=192, 12 heads, 2 layers, seeded weights; each JAX call once per module;
- the JAX test's ordering on the port alone: rowwise error < calibrated <
  naive, against the f32 block loop;
- the routing of ``run_window_trunk``: a tuple reaches "int8_static" on
  "fused2" only.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_int8_static_trunk.py -q``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_trunk_widths import Trunk
from transformerupscaler_tpu.models.common import WindowBlock as JaxWindowBlock
from transformerupscaler_tpu.ops.pallas.trunk import _layernorm as jax_layernorm
from transformerupscaler_tpu.ops.pallas.trunk2 import (
    fused_window_trunk_v2,
    quantize_gemm_weights as jax_quantize_gemm_weights,
)
from transformerupscaler_torch.kernels import trunk2 as T
from transformerupscaler_torch.models.common import (
    run_window_trunk,
    trunk_int8_scales,
)
from transformerupscaler_torch.ops.quant import (
    quantize_static,
    static_gemm_weights,
)
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DIM, HEADS, WS, LAYERS, N_WIN, SEED = 192, 12, 8, 2, 8, 17
GEMM_NAMES = ("qkv", "proj", "fc1", "fc2")
CONSTANT = {"clip4": 4.0, "coarse16": 16.0}


def _case():
    trunk = Trunk(DIM)
    tree = seeded_params(trunk, SEED)
    params_from_jax(trunk, tree)
    # jax.random.uniform windows, as the JAX tests feed them, made by numpy.
    win = np.random.default_rng(SEED).random(
        (N_WIN, WS * WS, DIM)).astype(np.float32)
    return trunk, tree, win


def _constant(s):
    return tuple(np.full((LAYERS, n), s, np.float32)
                 for n in (DIM, DIM, DIM, 4 * DIM))


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module")
def jax_calib(case):
    """dtype -> (the four sown maxima stacks, each block's output with and
    without the calibration), from the JAX blocks one by one."""
    _, tree, win = case
    out = {}
    for dt in ("float32", "bfloat16"):
        x = jnp.asarray(win).astype(dt)
        sown = {k: [] for k in GEMM_NAMES}
        outs = []
        for i in range(LAYERS):
            p = {"params": tree[f"blocks_{i}"]}
            cblk = JaxWindowBlock(DIM, WS, HEADS, dropout=0.0,
                                  dtype=getattr(jnp, dt),
                                  calib_trunk_int8=True)
            blk = JaxWindowBlock(DIM, WS, HEADS, dropout=0.0,
                                 dtype=getattr(jnp, dt))
            got, inter = cblk.apply(p, x, mutable=["intermediates"])
            ii = inter["intermediates"]
            for k, v in (("qkv", ii["trunk_i8_qkv"]),
                         ("proj", ii["attn"]["trunk_i8_proj"]),
                         ("fc1", ii["trunk_i8_fc1"]),
                         ("fc2", ii["trunk_i8_fc2"])):
                sown[k].append(np.asarray(v[0], np.float32))
            x = blk.apply(p, x)
            outs.append((np.array(got, np.float32),
                         np.array(x, np.float32)))
        out[dt] = (tuple(np.stack(sown[k]) for k in GEMM_NAMES), outs)
    return out


@pytest.fixture(scope="module")
def jax_static(case, jax_calib):
    """scales name -> (the scales, the JAX static int8 kernel's output at
    f32), for the calibrated scales and the two constants."""
    _, tree, win = case
    blocks = [tree[f"blocks_{i}"] for i in range(LAYERS)]
    scales = {"calibrated": jax_calib["float32"][0],
              **{k: _constant(s) for k, s in CONSTANT.items()}}
    return {name: (s, np.asarray(fused_window_trunk_v2(
        jnp.asarray(win), blocks, HEADS, WS, windows_per_cell=4,
        int8_acts=s, interpret=True), np.float32))
        for name, s in scales.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_gemm_weights_match_jax(rng, dtype):
    """Bit for bit: the int8 weights, the dequant scales sw / 127 and the
    inverse activation scales, with per-input-channel scales across four
    decades, a zero scale (the 1e-8 floor) and a zero weight column."""
    w = (rng.standard_normal((2, 192, 576)) / np.sqrt(192)).astype(np.float32)
    w[:, :, 7] = 0.0
    s_in = np.exp(rng.uniform(np.log(1e-2), np.log(1e2), (2, 192))
                  ).astype(np.float32)
    s_in[1, 3] = 0.0
    wj = jnp.asarray(w).astype(dtype)
    wq, sw, ia = jax_quantize_gemm_weights(wj, jnp.asarray(s_in))
    q, s, i = static_gemm_weights(torch.from_numpy(w).to(getattr(torch, dtype)),
                                  torch.from_numpy(s_in))
    assert q.dtype == torch.int8 and s.dtype == i.dtype == torch.float32
    assert q.shape == (2, 192, 576) and s.shape == (2, 576)
    assert i.shape == (2, 192)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sw)[:, 0])
    np.testing.assert_array_equal(i.numpy(), np.asarray(ia)[:, 0])


def test_quantize_static_matches_jax(rng):
    """The activation quantize of trunk2.py:182, bit for bit, with values
    past the clip and exact half steps."""
    x = (rng.standard_normal((64, 192)) * 3.0).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 200.0, -300.0, 0.0])
    ia = rng.uniform(1.0, 60.0, 192).astype(np.float32)
    ia[:8] = 1.0
    want = jnp.clip(jnp.round(jnp.asarray(x) * jnp.asarray(ia)), -127.0, 127.0)
    got = quantize_static(torch.from_numpy(x), torch.from_numpy(ia))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().max() == 127.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_matches_jax(case, jax_calib, dtype):
    """Each port block, calibrating on the JAX block loop's input to that
    block, records the maxima the JAX block sows, and the calibration
    leaves its output as it is (bit for bit on the port; JAX's own
    within the JAX test's rtol 1e-6, atol 1e-6); ``trunk_int8_scales`` is
    the port's block loop with them stacked. f32: rtol 1e-6, atol 1e-6 (the
    JAX test's; the f32 LayerNorm statistics sum in another order: measured
    max 2.4e-6 abs, 1.5e-6 relative, at maxima of 2-4). bf16: v is the
    bf16 product with the f32 bias added in f32, as JAX promotes it; the
    LN and GELU outputs are bf16 values on both sides, and a product summed
    in another order can move one element one bf16 step: rtol 2^-7
    (measured: LN outputs and v equal, the GELU maxima 0.0065 relative)."""
    trunk, _, win = case
    tdt = getattr(torch, dtype)
    want, jouts = jax_calib[dtype]
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=0))
    x = torch.from_numpy(win).to(tdt)
    with torch.inference_mode():
        for i, blk in enumerate(trunk.blocks):
            x_jax = torch.from_numpy(win if i == 0 else jouts[i - 1][1]
                                     ).to(tdt)
            calib = {}
            y_cal = blk(x_jax, "xla", calib)
            torch.testing.assert_close(y_cal, blk(x_jax, "xla"), atol=0,
                                       rtol=0)
            np.testing.assert_allclose(jouts[i][0], jouts[i][1], rtol=1e-6,
                                       atol=1e-6)
            for k, w in zip(GEMM_NAMES, want):
                assert calib[k].dtype == torch.float32, k
                np.testing.assert_allclose(calib[k].numpy(), w[i],
                                           err_msg=k, **tol)
        got = trunk_int8_scales(trunk.blocks, x)
        mine = []
        for blk in trunk.blocks:
            calib = {}
            x = blk(x, "xla", calib)
            mine.append(calib)
    assert len(got) == 4
    for k, g, w in zip(GEMM_NAMES, got, want):
        assert tuple(g.shape) == w.shape, k
        torch.testing.assert_close(g, torch.stack([c[k] for c in mine]),
                                   atol=0, rtol=0)


def _static_plain(trunk, win, scales):
    params = T.add_static_int8(
        T.stack_trunk_params(trunk.blocks, torch.float32), scales)
    with torch.inference_mode():
        return T.fused_window_trunk(torch.from_numpy(win), params,
                                    "int8_static").numpy(), params


# (max abs, mean abs) against the JAX kernel, each about three to four
# times its reading. Measured (f32, this file's inputs, outputs of mean abs
# 1.08; the same at 1, 2 and 8 torch threads): calibrated 0.0092 / 6.0e-6
# and clip4 0.057 / 6.4e-4, where int8 roundings flip; coarse16 7.2e-7 /
# 3.3e-8, where none does and a third of the elements differ by f32
# roundings only.
STATIC_BOUNDS = {"calibrated": (0.03, 2e-5), "clip4": (0.15, 2e-3),
                 "coarse16": (3e-6, 1.5e-7)}


@pytest.mark.parametrize("scales", ["calibrated", "clip4", "coarse16"])
def test_static_plain_matches_pallas(case, jax_static, scales):
    """Both sides quantize the same values the same way (the tests above),
    but a GEMM input that differs by an f32 rounding (JAX's paired kernel
    sums its attention and LayerNorm in another order) can land on the
    other side of an int8 rounding boundary: that element's product moves
    by one quantization step, |w| / ia, and attention carries it into the
    window's other tokens. That flip is the only difference allowed: max
    and mean abs bounds a few times the measured ones (``STATIC_BOUNDS``),
    at values of about 1; and the quantized layer-0 qkv input agrees with
    JAX's on all but a share of 1e-4 of its elements (measured: all). The
    constant 4.0 sits below the calibrated maxima of every GEMM input (up
    to 5.1), so those inputs clip at +-127."""
    trunk, tree, win = case
    s, want = jax_static[scales]
    got, params = _static_plain(trunk, win, s)
    assert got.shape == want.shape
    err = np.abs(got - want)
    bmax, bmean = STATIC_BOUNDS[scales]
    assert err.max() <= bmax and err.mean() <= bmean, (err.max(), err.mean())
    with torch.inference_mode():
        bf = T.fused_window_trunk(torch.from_numpy(win), params).numpy()
    assert np.abs(got - bf).max() > 1e-3  # the int8 products ran
    # The first GEMM input, quantized on both sides from the same windows.
    x = jnp.asarray(win).reshape(-1, DIM)
    b0 = tree["blocks_0"]
    y = jax_layernorm(x, jnp.asarray(b0["norm1"]["scale"])[None],
                      jnp.asarray(b0["norm1"]["bias"])[None])
    ia = 127.0 / jnp.maximum(jnp.asarray(s[0][0]), 1e-8)
    want_q = np.asarray(jnp.clip(jnp.round(y * ia), -127.0, 127.0))
    got_q = quantize_static(
        T._layernorm(torch.from_numpy(win).reshape(-1, DIM),
                     params["ln1s"][0], params["ln1b"][0]),
        params["qkvw_ia"][0]).numpy()
    assert (got_q != want_q).mean() <= 1e-4
    if scales == "clip4":  # inputs past 4.0 reach every GEMM: the clip ran
        calibrated = jax_static["calibrated"][0]
        assert all((c.max(axis=1) > 4.0).any() for c in calibrated)


def test_static_error_order_on_the_port(case, jax_calib):
    """The JAX test's ordering, on the port's plain versions alone, against
    the f32 block loop: rowwise error < calibrated error < naive (constant
    8.0) error; the calibrated trunk within 0.2, as the JAX test holds its
    kernel. Measured: rowwise 0.102, calibrated 0.128, naive 0.333 max abs
    at outputs of mean abs 1.08."""
    trunk, _, win = case
    x = torch.from_numpy(win)
    with torch.inference_mode():
        exact = x
        for blk in trunk.blocks:
            exact = blk(exact, "xla")
        cal = trunk_int8_scales(trunk.blocks, x)
        params = T.stack_trunk_params(trunk.blocks, torch.float32, True)
        errs = {}
        for name, s in (("calibrated", cal), ("naive", _constant(8.0))):
            p = T.add_static_int8(params, s)
            errs[name] = (T.fused_window_trunk(x, p, "int8_static")
                          - exact).abs().max().item()
        errs["rowwise"] = (T.fused_window_trunk(x, params, "int8_rowwise")
                           - exact).abs().max().item()
    assert errs["rowwise"] < errs["calibrated"] < errs["naive"], errs
    assert errs["calibrated"] < 0.2, errs


def test_static_int8_acts_routing(case, rng):
    """``run_window_trunk(..., int8_acts=<four scale stacks>)``: on "fused2"
    the trunk runs in mode "int8_static" with weights folded from these
    scales; "xla", "pallas" and "fused" ignore the tuple, as in JAX
    (bit-identical to without); wrong shapes or counts raise ValueError
    naming them; an unknown string still raises."""
    trunk, _, _ = case
    tokens = torch.from_numpy(
        rng.standard_normal((1, 8, 16, DIM)).astype(np.float32))
    scales = tuple(torch.from_numpy(s) for s in _constant(6.0))
    seen = []
    real = T.fused_window_trunk

    def spy(win, params, mode="v2"):
        seen.append(mode)
        return real(win, params, mode)

    import transformerupscaler_torch.models.common as common
    common.fused_window_trunk = spy
    try:
        got = run_window_trunk(tokens, trunk.blocks, WS, "fused2",
                               int8_acts=scales)
        for impl in ("xla", "pallas", "fused"):
            torch.testing.assert_close(
                run_window_trunk(tokens, trunk.blocks, WS, impl,
                                 int8_acts=scales),
                run_window_trunk(tokens, trunk.blocks, WS, impl),
                atol=0, rtol=0)
    finally:
        common.fused_window_trunk = real
    assert seen == ["int8_static", "v1", "v1"]
    win = tokens.reshape(1, 1, 8, 2, 8, DIM).permute(0, 1, 3, 2, 4, 5)
    want = T.fused_window_trunk_plain(
        win.reshape(2, 64, DIM),
        T.add_static_int8(T.stack_trunk_params(trunk.blocks, torch.float32),
                          scales),
        "int8_static")
    torch.testing.assert_close(
        got, want.reshape(1, 2, 8, 8, DIM).permute(0, 2, 1, 3, 4)
        .reshape(1, 8, 16, DIM), atol=0, rtol=0)
    for bad in (scales[:3], scales[:3] + (scales[0],),
                tuple(s[:1] for s in scales)):
        with pytest.raises(ValueError, match="int8_acts"):
            run_window_trunk(tokens, trunk.blocks, WS, "fused2",
                             int8_acts=bad)
    with pytest.raises(ValueError, match="int8_acts"):
        run_window_trunk(tokens, trunk.blocks, WS, "fused2",
                         int8_acts="columnwise")


def test_static_kept_pack_skips_the_fold(case, rng, monkeypatch):
    """``run_window_trunk`` folds the static weights on each call unless
    ``stacked`` is ``add_static_int8``'s pack for the very ``int8_acts``
    tuple it is given: then it folds nothing, with the same output as
    scales of equal values in another tuple, which it folds."""
    import transformerupscaler_torch.models.common as common

    trunk, _, _ = case
    tokens = torch.from_numpy(
        rng.standard_normal((1, 8, 16, DIM)).astype(np.float32))
    scales = tuple(torch.from_numpy(s) for s in _constant(6.0))
    kept = T.add_static_int8(
        T.stack_trunk_params(trunk.blocks, torch.float32), scales)
    folds = []
    real = common.add_static_int8
    monkeypatch.setattr(common, "add_static_int8",
                        lambda p, s: (folds.append(s), real(p, s))[1])
    got = run_window_trunk(tokens, trunk.blocks, WS, "fused2", kept, scales)
    assert folds == []
    again = tuple(s.clone() for s in scales)
    want = run_window_trunk(tokens, trunk.blocks, WS, "fused2", kept, again)
    assert len(folds) == 1 and folds[0] is again
    torch.testing.assert_close(got, want, atol=0, rtol=0)
