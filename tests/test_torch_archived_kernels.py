"""The JAX package's archived kernels in the port, on the CPU, where each
wrapper computes its plain version, against the Pallas kernels in interpret
mode:

- row 19, ``kernels.conv3x3.conv3x3`` against
  ``ops/pallas/conv3x3.py:73 conv3x3_pallas``: f32 at the cases of
  ``tests/test_pallas_conv.py`` and that file's tolerance, and bf16 with a
  bias off the bf16 grid, which the TPU kernel rounds before adding it;
- rows 20 and 21, ``kernels.patch_kernels.fused_patch_embed`` and
  ``fused_patch_unembed_add`` against ``ops/pallas/patch_kernels.py:50,
  106``: f32 at the shapes of ``tests/test_pallas_fused.py``, and bf16 with
  a bias off the bf16 grid.

Each JAX call runs once per module. Run:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_archived_kernels.py -q``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops.pallas.conv3x3 import conv3x3_pallas
from transformerupscaler_tpu.ops.pallas.patch_kernels import (
    fused_patch_embed as jax_fused_patch_embed,
    fused_patch_unembed_add as jax_fused_patch_unembed_add,
)
from transformerupscaler_torch import kernels as K
from transformerupscaler_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
from transformerupscaler_torch.kernels.patch_kernels import (
    fused_patch_embed,
    fused_patch_unembed_add,
)

BF16_STEP = 2.0 ** -7  # one bf16 step is at most 2^-7 of the value

# tests/test_pallas_conv.py's cases: (batch, H, W, C, O, relu, bias).
CONV_CASES = {
    "64-64-relu-bias": (1, 16, 32, 64, 64, True, True),
    "64-256-bias": (1, 16, 32, 64, 256, False, True),
    "256-16": (1, 16, 32, 256, 16, False, False),
    "8-8-relu": (1, 16, 32, 8, 8, True, False),
    "batch3-16-8": (3, 8, 16, 16, 8, False, False),
    "odd-height-8-8": (1, 6, 16, 8, 8, False, False),
}


def _conv_inputs(seed, b, h, w, c, o, bias):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    bb = rng.standard_normal(o).astype(np.float32) if bias else None
    return x, k, bb


def _jnp(a, dtype="float32"):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_convs():
    """case -> the JAX kernel's f32 output, th=4 as the JAX tests run it;
    "bf16": the 64 -> 64 case with bias and ReLU at bf16."""
    out = {}
    for i, (name, (b, h, w, c, o, relu, bias)) in enumerate(
            CONV_CASES.items()):
        x, k, bb = _conv_inputs(i, b, h, w, c, o, bias)
        out[name] = np.asarray(conv3x3_pallas(
            _jnp(x), _jnp(k), _jnp(bb), relu=relu, th=4, interpret=True))
    x, k, bb = _conv_inputs(99, 1, 16, 32, 64, 64, True)
    out["bf16"] = _f32(conv3x3_pallas(
        _jnp(x, "bfloat16"), _jnp(k), _jnp(bb), relu=True, th=4,
        interpret=True))
    return out


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv3x3_matches_pallas_f32(jax_convs, case):
    """f32 at tests/test_pallas_conv.py's tolerance (atol 2e-4, rtol 1e-3):
    the same sums in another order. The wrapper on CPU tensors is the plain
    version, the TPU tiling arguments ignored."""
    b, h, w, c, o, relu, bias = CONV_CASES[case]
    x, k, bb = _conv_inputs(list(CONV_CASES).index(case), b, h, w, c, o,
                            bias)
    K.reset_launches()
    got = conv3x3(_t(x), _t(k), _t(bb), relu=relu, th=4)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, o)
    assert sum(K.launch_counts().values()) == 0
    np.testing.assert_allclose(got.numpy(), jax_convs[case], atol=2e-4,
                               rtol=1e-3)
    torch.testing.assert_close(got, conv3x3_plain(_t(x), _t(k), _t(bb), relu),
                               atol=0, rtol=0)


def test_conv3x3_matches_pallas_bf16_bias_rounding(jax_convs):
    """bf16, 64 -> 64 with bias and ReLU, the bias off the bf16 grid: the
    TPU kernel rounds it to bf16 before the f32 add (conv3x3.py:103-104),
    and so does the port. Both round the f32 sum once: within one bf16 step
    (rtol 2^-7, atol 1e-3 for the f32 summation order). The rounding
    shows: with the f32 bias the port would round differently from JAX at
    many more elements. Measured: 0.006% of elements apart (by 1.9e-6 at
    most) with the rounded bias, 10% with the f32 bias."""
    x, k, bb = _conv_inputs(99, 1, 16, 32, 64, 64, True)
    xb = _t(x, torch.bfloat16)
    got = conv3x3(xb, _t(k), _t(bb), relu=True).float().numpy()
    want = jax_convs["bf16"]
    np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=1e-3)
    unrounded = torch.relu(conv3x3_plain(xb.float(), _t(k).bfloat16().float())
                           + _t(bb)).bfloat16().float().numpy()
    differ = (got != want).mean()
    differ_unrounded = (unrounded != want).mean()
    assert differ <= 0.01 and differ_unrounded >= max(4 * differ, 0.01), (
        differ, differ_unrounded)


@pytest.fixture(scope="module")
def patch_case():
    """tests/test_pallas_fused.py's inputs (x (1, 32, 48, 64), D = 192) and,
    per dtype, the JAX kernels' outputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 48, 64)).astype(np.float32)
    ke = (rng.standard_normal((8, 8, 64, 192)) * 0.05).astype(np.float32)
    be = rng.standard_normal(192).astype(np.float32)
    ku = (rng.standard_normal((192, 8, 8, 64)) * 0.05).astype(np.float32)
    bu = rng.standard_normal(64).astype(np.float32)
    out = {}
    for dt in ("float32", "bfloat16"):
        tok = jax_fused_patch_embed(_jnp(x, dt), _jnp(ke), _jnp(be))
        out[dt] = (_f32(tok), _f32(jax_fused_patch_unembed_add(
            tok, _jnp(x, dt), _jnp(ku), _jnp(bu))))
    return (x, ke, be, ku, bu), out


def test_fused_patch_kernels_match_pallas_f32(patch_case):
    """f32 at tests/test_pallas_fused.py's tolerance (rtol, atol 1e-5):
    the embed and the unembed + add against the Pallas kernels, each on
    the same inputs, the unembed's tokens the JAX embed's."""
    (x, ke, be, ku, bu), out = patch_case
    tok_j, un_j = out["float32"]
    K.reset_launches()
    tok = fused_patch_embed(_t(x), _t(ke), _t(be))
    assert tok.shape == (1, 4, 6, 192) and tok.dtype == torch.float32
    np.testing.assert_allclose(tok.numpy(), tok_j, rtol=1e-5, atol=1e-5)
    un = fused_patch_unembed_add(_t(tok_j.copy()), _t(x), _t(ku), _t(bu))
    assert un.shape == x.shape and un.dtype == torch.float32
    np.testing.assert_allclose(un.numpy(), un_j, rtol=1e-5, atol=1e-5)
    assert sum(K.launch_counts().values()) == 0


def test_fused_patch_embed_matches_pallas_bf16(patch_case):
    """bf16, the bias off the bf16 grid: rounded to bf16 before the f32 add
    (patch_kernels.py:87), then one rounding; the f32 sum runs in another
    order (the TPU kernel sums 32 products of K = 128): within one bf16
    step (rtol 2^-7, atol 1e-3). Measured: every token equal, 17% apart
    with the f32 bias."""
    (x, ke, be, _, _), out = patch_case
    want = out["bfloat16"][0]
    xb = _t(x, torch.bfloat16)
    got = fused_patch_embed(xb, _t(ke), _t(be)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=1e-3)
    unrounded = K.stream.embed_plain(xb, _t(ke), _t(be)).float().numpy()
    differ, differ_unrounded = (got != want).mean(), (unrounded != want).mean()
    assert differ <= 0.01 and differ_unrounded >= max(4 * differ, 0.01), (
        differ, differ_unrounded)


def _unembed_steps(tok, feat, ku, bu, roundings):
    """The unembed + add in bf16 with its sum rounded ``roundings`` times
    after the product: 3 as the Pallas source writes it (dt(acc), + dt(bias)
    in dt, + feat in dt), 1 if the two adds were carried in f32."""
    d = tok.shape[-1]
    y = (tok.float() @ ku.bfloat16().float().reshape(d, -1)).bfloat16()
    y = (y.reshape(1, 4, 6, 8, 8, 64).permute(0, 1, 3, 2, 4, 5)
         .reshape(1, 32, 48, 64))
    b = bu.bfloat16()
    if roundings == 3:
        return ((y + b) + feat).float()
    return (y.float() + b.float() + feat.float()).bfloat16().float()


def test_fused_patch_unembed_add_matches_pallas_bf16(patch_case):
    """bf16, the bias off the bf16 grid and feat a bf16 map. The Pallas
    source rounds three times (patch_kernels.py:99-103, 126): y =
    dt(tokens @ W), y + dt(bias) in dt, then + feat in dt; the port does
    too. XLA on the CPU could carry such a chain of bf16 adds in f32 (its
    excess-precision default) and round once; the test finds out which
    form the interpret-mode reference computes: the three-rounding form
    equals it on all but 2e-5 of the elements (one bf16 step of y where
    XLA's bf16 dot sums in another order), the one-rounding form on only
    77%. So the port follows the source, held within one bf16 step of the
    output (rtol 2^-7) plus one of the product y, which the adds can carry
    into a smaller output (atol 2^-7 max |y|). Measured: two elements
    differ, by 0.0156 at an output of -2.83 and by 0.0078 at 0.19."""
    (x, ke, be, ku, bu), out = patch_case
    tok_j, want = out["bfloat16"]
    tok = _t(tok_j.copy(), torch.bfloat16)
    xb = _t(x, torch.bfloat16)
    got = fused_patch_unembed_add(tok, xb, _t(ku), _t(bu))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float()
    three = _unembed_steps(tok, xb, _t(ku), _t(bu), 3)
    torch.testing.assert_close(got, three, atol=0, rtol=0)
    once = _unembed_steps(tok, xb, _t(ku), _t(bu), 1).numpy()
    assert (three.numpy() != want).mean() <= 1e-4
    assert (once != want).mean() >= 0.1  # the middle rounding shows
    y_max = (tok.float() @ _t(ku).bfloat16().float().reshape(192, -1)
             ).abs().max().item()
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_STEP,
                               atol=BF16_STEP * y_max)


def test_archived_wrappers_have_counters_and_plain_versions():
    """The archived wrappers' counters and plain versions cover each other;
    none is a serving wrapper's, so no model reaches them."""
    assert set(K.ARCHIVED_PLAIN_VERSIONS) == set(K.ARCHIVED_LAUNCHES)
    assert not set(K.ARCHIVED_LAUNCHES) & set(K.LAUNCHES)
    for name, plain in K.ARCHIVED_PLAIN_VERSIONS.items():
        assert plain.__name__ == name + "_plain"
