"""The weight layouts the Hopper conv kernels read, checked on the CPU.

``conv3x3_weight_rows`` gives ``csrc/conv3x3.cu`` the HWIO kernel as (9 C,
O) rows (dy, dx, c); ``tail_slabs`` gives ``csrc/conv_tail.cu`` the tail
kernel as K-major rows (group, dx, dy, output) of 64 channels. Each test
computes the conv from the packed layout the way the kernel indexes it, in
plain PyTorch, and holds it against the plain version of the wrapper:
``conv3x3_plain`` and ``tail_conv_plain``. Inputs and weights are small
multiples of 2^-4 and 2^-6, so every product and every f32 sum is exact and
the two must agree bit for bit whatever the summation order.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
