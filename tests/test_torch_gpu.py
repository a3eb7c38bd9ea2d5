"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the serving frame does not reach (batch 2, sizes that are not
tile multiples). chip_smoke.py covers the serving shapes.

Marked ``gpu``; every test skips without a CUDA device. This file imports no
JAX, so on a GPU host without JAX it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

bf16 outputs must agree within one bf16 rounding step (rtol 2^-7) plus
atol 1e-3 (f32 summation order); f32 outputs within rtol 1e-5, atol 1e-4.
"""

import pytest
import torch

from transformerupscaler_torch.kernels import stream as S

pytestmark = pytest.mark.gpu
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
F32_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("shape", [(1, 24, 48), (2, 13, 37)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_kernel_matches_plain(gen, shape, relu):
    x = _rn(gen, *shape, 64).bfloat16()
    k, b = _rn(gen, 3, 3, 64, 64, std=0.05), _rn(gen, 64)
    _close(S.conv3x3_stream(x, k, b, relu), S.conv3x3_plain(x, k, b, relu),
           BF16_TOL)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("co", [12, 27, 48])
@pytest.mark.parametrize("kh", [5, 7])
def test_tail_kernel_matches_plain(gen, kh, co, out_dtype):
    x = _rn(gen, 2, 13, 37, 64).bfloat16()
    k, b = _rn(gen, kh, kh, 64, co, std=0.02), _rn(gen, co)
    got = S.tail_conv_stream(x, k, b, True, out_dtype)
    assert got.dtype == out_dtype
    _close(got, S.tail_conv_plain(x, k, b, True, out_dtype),
           F32_TOL if out_dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("b,ht,wt,d", [(2, 3, 5, 64), (1, 2, 4, 192)])
def test_embed_kernel_matches_plain(gen, b, ht, wt, d):
    f = _rn(gen, b, 8 * ht, 8 * wt, 64).bfloat16()
    k, bias = _rn(gen, 8, 8, 64, d, std=0.02), _rn(gen, d)
    _close(S.embed_stream(f, k, bias), S.embed_plain(f, k, bias), BF16_TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_unembed_kernel_matches_plain(gen, relu):
    tok = _rn(gen, 2, 3, 5, 48).bfloat16()
    f = _rn(gen, 2, 24, 40, 64).bfloat16()
    k, bias = _rn(gen, 48, 8, 8, 64, std=0.05), _rn(gen, 64)
    _close(S.unembed_combine_stream(tok, f, k, bias, relu),
           S.unembed_combine_plain(tok, f, k, bias, relu), BF16_TOL)


def test_wrappers_count_launches_and_reject_bad_input(gen):
    x = _rn(gen, 1, 8, 16, 64).bfloat16()
    k = _rn(gen, 3, 3, 64, 64)
    S.reset_launches()
    S.conv3x3_stream(x, k)
    assert S.LAUNCHES["conv3x3_stream"] == 1
    with pytest.raises(TypeError):
        S.conv3x3_stream(x.float(), k)
    with pytest.raises(ValueError):
        S.conv3x3_stream(x.transpose(1, 2), k)
    with pytest.raises(ValueError):
        S.tail_conv_stream(x, _rn(gen, 3, 3, 64, 12))
    assert S.LAUNCHES["conv3x3_stream"] == 1
