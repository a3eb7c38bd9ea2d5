"""The weight layouts the Hopper conv kernels read, checked on the CPU.

``conv3x3_weight_rows`` gives ``csrc/conv3x3.cu`` the HWIO kernel as (9 C,
O) rows (dy, dx, c); ``tail_slabs`` gives ``csrc/conv_tail.cu`` and
``csrc/tail_strip.cu`` a k x k kernel as K-major rows (group, dx, dy,
output) of 64 channels (the split tail's mid in a 5x5 frame);
``finish_slabs`` gives the split tail its finish weights' hi and lo halves
side by side in the channels. Each test computes the conv from the packed
layout the way the kernel indexes it, in plain PyTorch, and holds it
against the plain version of the wrapper: ``conv3x3_plain``,
``tail_conv_plain`` and ``tail_finish_plain`` in its three ``hi_lo_fin``
modes. Inputs and weights are small multiples of powers of two, so every
product and every f32 sum is exact and the two must agree bit for bit
whatever the summation order.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.kernels import stream as S


def _grid(rng, *shape, scale):
    """Small integers times ``scale``: exact in bf16 and in f32 sums."""
    return torch.from_numpy(
        rng.integers(-8, 9, size=shape).astype(np.float32) * scale)


@pytest.mark.parametrize("shape", [(1, 5, 9), (2, 13, 37)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_weight_rows_compute_conv3x3_plain(shape, relu):
    rng = np.random.default_rng(0)
    x = _grid(rng, *shape, 64, scale=2.0 ** -4).bfloat16()
    k = _grid(rng, 3, 3, 64, 64, scale=2.0 ** -6)
    b = _grid(rng, 64, scale=2.0 ** -3)
    rows = S.conv3x3_weight_rows(k)
    assert rows.shape == (576, 64) and rows.dtype == torch.bfloat16
    # The kernel's K order: tap (dy, dx) major, channel minor; the A operand
    # of tap (dy, dx) is the input shifted by (dy - 1, dx - 1).
    _, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=-1)
    y = patches @ rows.float() + b
    if relu:
        y = torch.relu(y)
    assert torch.equal(y.bfloat16(), S.conv3x3_plain(x, k, b, relu))


@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_tail_slabs_compute_tail_conv_plain(k, co):
    """The kernel's tail: for each 16-output group and mid row, one GEMM
    over (dx, c) whose N columns are (dy, output); output row y sums the
    dy columns of mid rows y + dy - P (the shift-add)."""
    rng = np.random.default_rng(k * 100 + co)
    npad = next(n for n in S.TAIL_NPAD if co <= n)
    f = _grid(rng, 2, 11, 23, 64, scale=2.0 ** -4).bfloat16()
    kt = _grid(rng, k, k, 64, co, scale=2.0 ** -6)
    bt = _grid(rng, co, scale=2.0 ** -3)
    slabs = S.tail_slabs(kt, npad)
    assert slabs.shape == (npad // 16 * k * k * 16, 64)
    groups = slabs.float().reshape(npad // 16, k, k, 16, 64)  # g dx dy o c
    p = (k - 1) // 2
    b, h, w, _ = f.shape
    fp = F.pad(f.float(), (0, 0, p, p, p, p))
    out = torch.zeros(b, h, w, npad)
    for g in range(npad // 16):
        # d[b, m, x, dy, o]: mid row m's share of output row m + p - dy.
        d = sum(torch.einsum("bmxc,doc->bmxdo", fp[:, :, dx:dx + w],
                             groups[g, dx]) for dx in range(k))
        for dy in range(k):
            out[..., 16 * g:16 * g + 16] += d[:, dy:dy + h, :, dy]
    y = out[..., :co] + bt
    assert torch.equal(y.bfloat16(), S.tail_conv_plain(f, kt, bt))
    # Outputs co .. npad - 1 have zero weights.
    by_output = groups.permute(0, 3, 1, 2, 4).reshape(npad, k, k, 64)
    assert not by_output[co:].any()


def _finish_data(rng, kind, kh, cm, co):
    """Grid inputs on which every sum of the split tail is exact in f32.
    "mid_lo": a mid of up to 14 bits (its lo half nonzero) and finish
    weights exact in bf16; "w_lo": a mid exact in bf16 (two input channels)
    and finish weights a / 4 + b 2^-11, whose lo half is b 2^-11."""
    if kind == "mid_lo":
        x = _grid(rng, 2, 9, 140, 64, scale=2.0 ** -4) / 4
        km = _grid(rng, kh, kh, 64, cm, scale=2.0 ** -6) / 4
        bm = _grid(rng, cm, scale=2.0 ** -10)
        kf = _grid(rng, 3, 3, cm, co, scale=2.0 ** -3) / 4
    else:
        x = torch.zeros(2, 9, 140, 64)
        x[..., :2] = torch.from_numpy(
            rng.integers(-1, 2, size=(2, 9, 140, 2)).astype(np.float32) / 4)
        km = torch.from_numpy(
            rng.integers(-1, 2, size=(kh, kh, 64, cm)).astype(np.float32) / 4)
        bm = _grid(rng, cm, scale=2.0 ** -4)
        kf = torch.from_numpy(
            rng.integers(-1, 2, size=(3, 3, cm, co)).astype(np.float32) / 4
            + rng.choice([-1, 1], size=(3, 3, cm, co)) * 2.0 ** -11)
    return x.bfloat16(), km, bm, kf, _grid(rng, co, scale=2.0 ** -3)


def _split_tail_as_kernel(x, km, bm, kf, bf, mode, cmp_, cop):
    """tail_strip.cu's split tail, indexed as the kernel indexes: half-strips
    of 62 outputs, each a mid row of 64 pixels (column x0 - 1 + q) from the
    input ring row's pixels x0 - 3 + r; the mid as a 5x5 shift-add over the
    ``tail_slabs`` of the kernel in a 5x5 frame; mid rows of 64 channels, hi at
    0 .. cmp_ - 1 and, in "full", lo at cmp_ .. 2 cmp_ - 1; the finish as a
    3x3 shift-add over the ``finish_slabs``, its products by mode: hi with
    the hi weights, then hi with the lo weights ("wf", "full"), lo with the
    hi weights ("full")."""
    b, h, w, _ = x.shape
    cm, co = km.shape[3], kf.shape[3]
    wm = S.tail_slabs(km, cmp_, frame=5).float().reshape(
        cmp_ // 16, 5, 5, 16, 64)  # group dx dy channel c
    wf = S.finish_slabs(kf, cmp_, cop).float().reshape(
        cop // 16, 3, 3, 16, 64)  # group dx dy output c
    bias_m = torch.zeros(cmp_)
    bias_m[:cm] = bm
    out = torch.zeros(b, h, w, co)
    xf = x.float()
    for x0 in range(0, w, 62):
        cols = torch.arange(x0 - 3, x0 + 69)
        ring = torch.zeros(b, h + 4, 72, 64)  # two zero rows each side
        ok = (cols >= 0) & (cols < w)
        ring[:, 2:2 + h, ok] = xf[:, :, cols[ok]]
        # d[b, m, q, dy, ch]: input row m's share of mid row m + 2 - dy.
        d = sum(torch.einsum("bmqc,gdnc->bmqdgn", ring[:, :, dx:dx + 64],
                             wm[:, dx]) for dx in range(5))
        d = d.reshape(b, h + 4, 64, 5, cmp_)
        mid = sum(d[:, dy:dy + h, :, dy] for dy in range(5)) + bias_m
        mcols = torch.arange(x0 - 1, x0 + 63)
        mid[:, :, (mcols < 0) | (mcols >= w)] = 0.0
        hi = mid.bfloat16().float()
        ring_m = torch.zeros(b, h + 2, 72, 64)  # a zero row each side
        ring_m[:, 1:1 + h, :64, :cmp_] = hi
        if mode == "full":
            ring_m[:, 1:1 + h, :64, cmp_:2 * cmp_] = (
                (mid - hi).bfloat16().float())
        hi_ch, lo_ch = slice(0, cmp_), slice(cmp_, 2 * cmp_)
        steps = [(hi_ch, hi_ch)]  # (A channels, B channels) of a product
        if mode != "off":
            steps.append((hi_ch, lo_ch))
        if mode == "full":
            steps.append((lo_ch, hi_ch))
        # e[b, m, p, dy, o]: mid row m's share of output row m + 1 - dy.
        e = sum(torch.einsum("bmpc,gdoc->bmpdgo",
                             ring_m[:, :, dx:dx + 64, a_ch],
                             wf[:, dx, :, :, b_ch])
                for dx in range(3) for a_ch, b_ch in steps)
        e = e.reshape(b, h + 2, 64, 3, cop)
        y = sum(e[:, dy:dy + h, :, dy] for dy in range(3))
        n = min(62, w - x0)
        out[:, :, x0:x0 + n] = y[:, :, :n, :co] + bf
    return out


@pytest.mark.parametrize("kh", [3, 5])
@pytest.mark.parametrize("cm,co", [(12, 12), (16, 16), (27, 27), (32, 32),
                                   (12, 48)])
@pytest.mark.parametrize("mode,kind", [("off", "mid_lo"), ("wf", "w_lo"),
                                       ("full", "mid_lo"), ("full", "w_lo")])
def test_split_tail_slabs_compute_tail_finish_plain(mode, kind, cm, co, kh):
    rng = np.random.default_rng(cm * 100 + co + kh)
    x, km, bm, kf, bf = _finish_data(rng, kind, kh, cm, co)
    cmp_, cop = next(p for p in ((16, 16), (32, 32), (16, 48))
                     if cm <= p[0] and co <= p[1])
    want = S.tail_finish_plain(x, km, bm, kf, bf, torch.float32, mode)
    got = _split_tail_as_kernel(x, km, bm, kf, bf, mode, cmp_, cop)
    assert torch.equal(got, want)
    slabs = S.finish_slabs(kf, cmp_, cop)
    assert slabs.shape == (cop // 16 * 9 * 16, 64)
    # The remainders the data is built to have.
    hi, lo = S._hi_lo(kf.float())
    assert (kind == "w_lo") == bool(lo.any())
