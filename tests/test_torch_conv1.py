"""conv1 of the port (``kernels.stream.conv1_stream``, on the CPU its plain
version) against the JAX package's two streamed conv1 kernels in Pallas
interpret mode: ``conv1_dots_stream`` and ``conv1_flat_stream``
(ops/pallas/stream.py:1269, 1385), bit for bit, in bf16 and f32.

The Pallas kernels read the width-2 packed input and write the TPU's
deinterleave4 layout; the test packs the NHWC input with a reshape and
turns the output back into NHWC with ``deint_to_nhwc``.

Both Pallas kernels compute each row slab as one dot with K = 108 (the 27
taps in (dy, dx, c) order, zeros between) and f32 accumulation.

- f32: XLA's CPU dot sums such a product as one fused multiply-add sequence
  over K when it has at least 64 rows, and in two blocks split at K = 64
  when it has 32 (a result then moves by an ulp). The slabs here are 16 or
  24 rows of 4 deinterleave groups, 64 or 96 dot rows: the order the plain
  version reproduces. Inputs are standard normal.
- bf16: XLA's CPU dot sums bf16 products in an order of the host's own (on
  a host with AMX-BF16 it matches no sequential or blocked f32 order), which
  the card's tensor cores do not share either. The bit-for-bit cases
  therefore take inputs on a grid, x in multiples of 2^-6 and weights in
  multiples of 2^-8 (both exact in bf16), where every partial sum of the 27
  products is exact in f32 (multiples of 2^-14 below 2^7: 21 bits), so the
  sum is the same in any order and the comparison holds the tap layout and
  the epilogue order alone. Standard normal bf16 inputs are also compared:
  within one bf16 step, on at most 0.1% of elements.

Each JAX result is computed once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops.pallas.stream import (
    conv1_dots_stream,
    conv1_flat_stream,
)
from transformerupscaler_torch.kernels import LAUNCHES
from transformerupscaler_torch.kernels import stream as S

SHAPES = ((1, 16, 32), (1, 24, 32))
DTYPES = ("bfloat16", "float32")
# Every shape and dtype with bias and ReLU; the bare form (no bias, no
# ReLU) once.
CASES = [(s, d, True) for s in SHAPES for d in DTYPES] + [
    (SHAPES[0], "bfloat16", False)]


def deint_to_nhwc(y) -> torch.Tensor:
    """(B, H, 4, G, 2 C) deinterleave4 -> (B, H, 8 G, C) NHWC."""
    y = torch.from_numpy(np.array(y, np.float32))
    b, h, _, g, c2 = y.shape
    return y.permute(0, 1, 3, 2, 4).reshape(b, h, 8 * g, c2 // 2)


def _inputs(shape, grid: bool = False):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((*shape, 3)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    if grid:
        x = np.clip(np.round(x * 64), -255, 255) / 64
        k = np.clip(np.round(k * 256), -255, 255) / 256
    return x, k, b


def _jax_conv1(shape, dtn, full, grid):
    x, k, b = _inputs(shape, grid)
    jdt = jnp.dtype(dtn)
    xp = jnp.asarray(x).astype(jdt).reshape(*shape[:2], shape[2] // 2, 6)
    kk = jnp.asarray(k).astype(jdt)
    bb = jnp.asarray(b) if full else None
    rows = shape[1]  # one slab: 64 or 96 dot rows
    return tuple(deint_to_nhwc(fn(xp, kk, bb, relu=full, rows=rows,
                                  interpret=True))
                 for fn in (conv1_dots_stream, conv1_flat_stream))


def _port_conv1(shape, dtn, full, grid):
    x, k, b = _inputs(shape, grid)
    return S.conv1_stream(torch.from_numpy(x).to(getattr(torch, dtn)),
                          torch.from_numpy(k),
                          torch.from_numpy(b) if full else None, relu=full)


@pytest.fixture(scope="module")
def jax_outputs():
    """(shape, dtype, with bias and ReLU) -> (dots, flat) in NHWC, bf16 on
    the grid; and ("normal", shape) -> the bf16 pair on standard normal
    inputs."""
    out = {(shape, dtn, full): _jax_conv1(shape, dtn, full,
                                          dtn == "bfloat16")
           for shape, dtn, full in CASES}
    for shape in SHAPES:
        out["normal", shape] = _jax_conv1(shape, "bfloat16", True, False)
    return out


IDS = [f"{s[1]}x{s[2]}-{d}-{'bias_relu' if r else 'bare'}"
       for s, d, r in CASES]


@pytest.mark.parametrize("shape,dtype,full", CASES, ids=IDS)
def test_conv1_plain_is_bit_exact_with_both_pallas_kernels(jax_outputs, shape,
                                                           dtype, full):
    before = LAUNCHES["conv1_stream"]
    got = _port_conv1(shape, dtype, full, dtype == "bfloat16")
    assert LAUNCHES["conv1_stream"] == before  # the CPU ran the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (*shape, 64)
    dots, flat = jax_outputs[shape, dtype, full]
    torch.testing.assert_close(got.float(), dots, rtol=0, atol=0)
    torch.testing.assert_close(got.float(), flat, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[1]}x{s[2]}"
                                               for s in SHAPES])
def test_conv1_plain_bf16_normal_inputs_within_one_step(jax_outputs, shape):
    got = _port_conv1(shape, "bfloat16", True, False).float()
    for want in jax_outputs["normal", shape]:
        off = got != want
        assert off.float().mean().item() <= 1e-3
        torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=0)


def test_conv1_epilogue_rounds_the_sum_before_the_bias():
    """In bf16 the f32 sum is rounded first and the bias added in bf16
    (stream.py:1259-1263): a sum of 1 + 2^-8 + 2^-10 rounds to 1 + 2^-7,
    and adding a bias of 2^-8 ties and rounds to even, 1 + 2^-6; an f32
    epilogue would round 1 + 2^-7 + 2^-10 once, to 1 + 2^-7."""
    x = torch.ones(1, 1, 1, 3, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 3, 64)
    k[1, 1, :, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -10])
    got = S.conv1_plain(x, k, torch.full((64,), 2.0 ** -8))
    assert got.dtype == torch.bfloat16
    assert got.float()[0, 0, 0, 0].item() == 1.0 + 2.0 ** -6


def test_conv1_plain_covers_every_row():
    """A height no slab size divides: every row is written (the JAX rows
    fallback leaves h % rows of them, stream.py:1321-1322)."""
    x, k, b = _inputs((1, 13, 20))
    got = S.conv1_plain(torch.from_numpy(x), torch.from_numpy(k),
                        torch.from_numpy(b), relu=False)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(k).permute(3, 2, 0, 1), torch.from_numpy(b),
        padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
