"""The int8 convs' Hopper kernels as arithmetic on the CPU: their weight
layouts and their index arithmetic, emulated in torch, against the plain
versions.

``conv3x3_int8_stream`` runs ``csrc/conv3x3.cu``'s int8 form: tiles of 4
rows x 64 pixels, a 6 x 72 pixel halo (zero outside the map), one
warpgroup a tile row, each of the 9 taps one product whose A is the halo row
started dx pixels in and whose B is the tap's K-major slab of
``conv3x3_int8_slabs``. ``tail_conv_int8_stream`` runs ``csrc/tail_strip.cu``'s
int8 tail: strips of 128 pixels owning 128 - 2P outputs, 136-pixel input
rows, two warpgroups of 64 pixels, one pass a 16-output group over each
block's range of strip-rows (cut into segments at strip ends), the
shift-add of ``csrc/strip.cuh`` in int32 (one k dx product chain a source
row, rows outside the image skipped, the partial output rows shifted one a
row), and the ``tail_slabs`` weights in int8. Both end in the epilogue
float(acc) * ks + bias, each step rounded in f32, ReLU, one rounding.

The emulations sum in int64 (the int32 sums are exact: 49 x 64 x 127^2 <
2^31) and must equal the plain versions bit for bit, every output written
(the buffers start as NaN).
"""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.kernels import stream as S

OUT_DTYPES = [torch.bfloat16, torch.float32]


def _case(seed, shape, k, co):
    """An int8 map and int8 HWIO weights (output 0 all zero, as a folded
    dead channel), per-output f32 scales and biases, from numpy."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (*shape, 64), dtype=np.int8))
    kq = rng.integers(-127, 128, (k, k, 64, co), dtype=np.int8)
    kq[..., 0] = 0
    ks = (rng.random(co) * 2e-4 + 1e-6).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return xq, torch.from_numpy(kq), torch.from_numpy(ks), torch.from_numpy(b)


def _epilogue(acc, ks, b, relu, out_dtype):
    v = acc.to(torch.float32) * ks  # float(acc), then one f32 rounding
    v = v + b
    if relu:
        v = torch.relu(v)
    return v.to(out_dtype)


def _row(xq, b, y, x_first, n):
    """Pixels x_first .. x_first + n - 1 of row y of batch b as int64 (n,
    64), zero outside the map: a TMA box row."""
    _, h, w, _ = xq.shape
    out = torch.zeros(n, 64, dtype=torch.int64)
    if 0 <= y < h:
        lo, hi = max(x_first, 0), min(x_first + n, w)
        if lo < hi:
            out[lo - x_first:hi - x_first] = xq[b, y, lo:hi].long()
    return out


def conv3x3_emulated(xq, kq, ks, b, relu, out_dtype):
    bsz, h, w, _ = xq.shape
    slabs = S.conv3x3_int8_slabs(kq).long().view(9, 64, 64)  # [tap][o][c]
    out = torch.full((bsz, h, w, 64), float("nan"), dtype=out_dtype)
    for bb in range(bsz):
        for y0 in range(0, h, 4):
            for x0 in range(0, w, 64):
                halo = [_row(xq, bb, y0 - 1 + r, x0 - 1, 72) for r in range(6)]
                for wg in range(4):
                    if y0 + wg >= h:
                        continue
                    acc = torch.zeros(64, 64, dtype=torch.int64)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        acc += halo[wg + dy][dx:dx + 64] @ slabs[tap].t()
                    n = min(64, w - x0)
                    out[bb, y0 + wg, x0:x0 + n] = _epilogue(
                        acc[:n], ks, b, relu, out_dtype)
    return out


def tail_emulated(xq, kq, ks, b, relu, out_dtype, blocks=5):
    bsz, h, w, _ = xq.shape
    k, co = kq.shape[0], kq.shape[3]
    p = (k - 1) // 2
    npad = next(n for n in S.TAIL_NPAD if co <= n)
    own = 128 - 2 * p
    # [group][dx][dy * 16 + output][channel]
    slabs = S.tail_slabs(kq, npad, dtype=torch.int8).long().view(
        npad // 16, k, 16 * k, 64)
    strips = -(-w // own)
    t_all = bsz * strips * h
    out = torch.full((bsz, h, w, co), float("nan"), dtype=out_dtype)
    for grp in range(npad // 16):
        oc = list(range(16 * grp, min(16 * grp + 16, co)))
        for blk in range(blocks):
            t, t1 = blk * t_all // blocks, (blk + 1) * t_all // blocks
            while t < t1:  # one segment: a strip's rows [y0, y1)
                bs = t // h
                y0, bb = t - bs * h, bs // strips
                x0 = (bs - bb * strips) * own
                y1 = min(h, y0 + t1 - t)
                for c in range(2):  # the two warpgroups' 64-pixel halves
                    part = [torch.zeros(64, 16, dtype=torch.int64)
                            for _ in range(2 * p)]
                    for m in range(y0 - p, y1 + p):
                        d = torch.zeros(64, k, 16, dtype=torch.int64)
                        if 0 <= m < h:  # else the zero pad: no products
                            row = _row(xq, bb, m, x0 - p, 136)
                            for dx in range(k):
                                a = row[64 * c + dx:64 * c + dx + 64]
                                d += (a @ slabs[grp, dx].t()).view(64, k, 16)
                        done = part[0] + d[:, 2 * p]
                        for i in range(2 * p - 1):
                            part[i] = part[i + 1] + d[:, 2 * p - 1 - i]
                        part[2 * p - 1] = d[:, 0]
                        y = m - p
                        if y < y0:
                            continue
                        xs = x0 + 64 * c
                        n = min(64, own - 64 * c, w - xs)
                        if n > 0:
                            out[bb, y, xs:xs + n, oc[0]:oc[-1] + 1] = \
                                _epilogue(done[:n, :len(oc)], ks[oc], b[oc],
                                          relu, out_dtype)
                t += y1 - y0
    return out


def test_conv3x3_int8_slabs_unpack_to_the_kernel():
    _, kq, _, _ = _case(0, (1, 1, 1), 3, 64)
    slabs = S.conv3x3_int8_slabs(kq)
    assert slabs.dtype == torch.int8 and tuple(slabs.shape) == (576, 64)
    assert torch.equal(slabs.view(3, 3, 64, 64).permute(0, 1, 3, 2), kq)


@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("k", [5, 7])
def test_int8_tail_slabs_unpack_to_the_kernel(k, co):
    _, kq, _, _ = _case(1, (1, 1, 1), k, co)
    npad = next(n for n in S.TAIL_NPAD if co <= n)
    slabs = S.tail_slabs(kq, npad, dtype=torch.int8)
    assert slabs.dtype == torch.int8
    assert tuple(slabs.shape) == (npad // 16 * k * k * 16, 64)
    # [group][dx][dy][output][channel] -> [dy][dx][channel][16 group + o]
    w = slabs.view(npad // 16, k, k, 16, 64).permute(2, 1, 4, 0, 3)
    w = w.reshape(k, k, 64, npad)
    assert torch.equal(w[..., :co], kq)
    assert not w[..., co:].any()


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 9, 70), (1, 6, 129)])
def test_conv3x3_int8_emulated_equals_plain(shape, relu, out_dtype):
    """Two tiles across and a ragged one, heights past one 4-row tile."""
    xq, kq, ks, b = _case(2, shape, 3, 64)
    got = conv3x3_emulated(xq, kq, ks, b, relu, out_dtype)
    want = S.conv3x3_int8_plain(xq, kq, ks, b, relu, out_dtype)
    assert torch.equal(got, want)
    assert torch.equal(S.conv3x3_int8_stream(xq, kq, ks, b, relu, out_dtype),
                       want)


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("k", [5, 7])
def test_tail_int8_emulated_equals_plain(k, co, relu, out_dtype):
    """x2 / x3 / x4 widths (npad 16 / 32 / 48: one to three passes), batch
    2 over two strips and a ragged one, ranges of five blocks that break
    into segments inside strips."""
    xq, kq, ks, b = _case(3 + k + co, (2, 7, 150), k, co)
    got = tail_emulated(xq, kq, ks, b, relu, out_dtype)
    want = S.tail_conv_int8_plain(xq, kq, ks, b, relu, out_dtype)
    assert torch.equal(got, want)
    assert torch.equal(
        S.tail_conv_int8_stream(xq, kq, ks, b, relu, out_dtype), want)
