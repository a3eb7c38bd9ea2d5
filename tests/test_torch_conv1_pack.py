"""What ``conv1_stream`` hands its CUDA kernel from the host, held on the
CPU against ``conv1_plain``'s (dy, dx, c) order.

``csrc/conv1.cu`` takes the HWIO weights as they are (rows k = (dy * 3 + dx)
* 3 + c of 64 outputs, rounded to bf16 in the kernel) and the host's tap
table ``conv1_taps()``: for each column k of the operand, the element
offset from an output pixel's slot in the kernel's halo tile. These tests
rebuild the kernel's halo tiles (both ways it fills them: the TMA box, and
the cp.async words whose rows shift by one element where W is odd), gather
every tile's operand through the table as the kernel's threads do, and
require it to equal the im2col operand built straight from the input, bit
for bit; then the operand times the weight rows must give
``conv1_plain``'s sums. No card is needed.
"""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.kernels import stream as S

TH, TW = S.CONV1_TILE
HP = S.CONV1_PITCH
HR = TH + 2


def _halo(x, b, y0, x0):
    """The halo stage the kernel fills for tile (b, y0, x0): HR rows of HP
    elements, element P of row r holding the input's column element
    3 x0 - 8 + P - s_r of row y0 - 1 + r (zero outside the image), s_r the
    cp.async path's shift (W odd, odd b H + y), 0 on the TMA path."""
    _, h, w, _ = x.shape
    flat = x.reshape(x.shape[0], h, 3 * w)
    stage = np.zeros((HR, HP), np.float32)
    for r in range(HR):
        y = y0 - 1 + r
        if not 0 <= y < h:
            continue
        s = 0 if w % 8 == 0 else w & (b * h + y) & 1
        for p in range(HP):
            c = 3 * x0 - 8 + p - s
            if 0 <= c < 3 * w:
                stage[r, p] = flat[b, y, c]
    return stage.reshape(-1)


def _gathered(x, b, y0, x0):
    """The tile's (TH * TW, 32) operand as the kernel's threads gather it:
    warp (row) w, pixel p, column k reads halo element w HP + 3 p + taps[k]
    plus the row's shift, zero where taps[k] < 0."""
    _, h, w, _ = x.shape
    tma = w % 8 == 0
    taps = S.conv1_taps()
    stage = _halo(x, b, y0, x0)
    a = np.zeros((TH, TW, 32), np.float32)
    for wr in range(TH):
        sh = 0 if tma else w & (b * h + y0 - 1 + wr) & 1
        for k, o in enumerate(taps):
            oo = max(o, 0)
            odd = 0 if tma or w % 2 == 0 else (oo // HP) & 1
            idx = wr * HP + 3 * np.arange(TW) + oo + ((sh ^ odd) & 1)
            a[wr, :, k] = stage[idx] if o >= 0 else 0.0
    return a


def _im2col(x, b, y0, x0):
    """The same operand straight from the input, columns in (dy, dx, c)
    order, zero padding, K padded to 32."""
    _, h, w, _ = x.shape
    xp = np.pad(x[b], ((1, TH + 1), (1, TW + 1), (0, 0)))
    a = np.zeros((TH, TW, 32), np.float32)
    for dy in range(3):
        for dx in range(3):
            k = (dy * 3 + dx) * 3
            a[:, :, k:k + 3] = xp[y0 + dy:y0 + dy + TH, x0 + dx:x0 + dx + TW]
    return a


def _frame(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    # bf16-valued, so that every product below is exact in f32
    x = torch.from_numpy(rng.random((b, h, w, 3), np.float32))
    return x.bfloat16().float().numpy()


def test_taps_are_the_operand_columns():
    taps = S.conv1_taps()
    assert len(taps) == 32 and taps[27:] == (-1,) * 5
    # every column stays inside the three halo rows a pixel reads
    assert 0 < min(taps[:27]) and max(taps[:27]) <= 2 * HP + 8 + S.CONV1_LEAD
    assert len(set(taps[:27])) == 27


@pytest.mark.parametrize("b,h,w", [(2, 13, 40), (2, 13, 37), (1, 9, 52),
                                   (1, 5, 8)])
def test_gathered_operand_is_im2col(b, h, w):
    """TMA (W = 40, 8), cp.async with even W (52) and with odd W (37: every
    other row shifted), ragged tiles at the bottom and right."""
    x = _frame(b, h, w)
    for bb in range(b):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                got = _gathered(x, bb, y0, x0)
                want = _im2col(x, bb, y0, x0)
                # pixels outside the image are computed but never stored
                ny, nx = min(TH, h - y0), min(TW, w - x0)
                np.testing.assert_array_equal(got[:ny, :nx], want[:ny, :nx])


@pytest.mark.parametrize("b,h,w", [(2, 13, 37), (1, 9, 64)])
def test_operand_times_weight_rows_is_conv1(b, h, w):
    """The gathered operand times the weights as the kernel reads them
    (HWIO rows k, zero rows 27..31) gives conv1_plain's f32 sums."""
    x = _frame(b, h, w, seed=1)
    rng = np.random.default_rng(2)
    kernel = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 3, 64))
                              .astype(np.float32))
    rows = np.zeros((32, 64), np.float64)
    rows[:27] = kernel.bfloat16().float().reshape(27, 64).numpy()
    want = S.conv1_plain(torch.from_numpy(x), kernel.bfloat16().float())
    got = np.zeros((b, h, w, 64), np.float64)
    for bb in range(b):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                ny, nx = min(TH, h - y0), min(TW, w - x0)
                a = _gathered(x, bb, y0, x0)[:ny, :nx].astype(np.float64)
                got[bb, y0:y0 + ny, x0:x0 + nx] = a @ rows
    np.testing.assert_allclose(got, want.double().numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64, torch.float16])
def test_weights_reach_the_kernel_as_bf16_or_f32(dtype):
    """f32 and bf16 pass as they are (the kernel rounds f32 to bf16 as
    ``.to(torch.bfloat16)`` does); other types are rounded to bf16 once."""
    k = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (3, 3, 3, 64))
                         ).to(dtype)
    got, is_f32 = S._bf16_or_f32(k, "kernel")
    assert is_f32 == (dtype == torch.float32)
    assert got.dtype in (torch.float32, torch.bfloat16)
    assert torch.equal(got.bfloat16(), k.to(torch.bfloat16))
    if dtype in (torch.float32, torch.bfloat16):
        assert got.data_ptr() == k.data_ptr()
