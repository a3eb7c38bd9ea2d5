"""The global attention core's plain version
(transformerupscaler_torch/kernels/gmha.py) and the port's
``multihead_attention`` against the JAX Pallas kernel ``global_mha`` in
interpret mode and against the JAX XLA op, on the CPU. f32 tolerance:
atol=1e-4, rtol=1e-4, as tests/test_pallas_stream.py holds the Pallas kernel
to the XLA op; bf16 bounds are stated at the test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops.attention import (
    multihead_attention as jax_multihead_attention,
)
from transformerupscaler_tpu.ops.pallas.gmha import global_mha as jax_global_mha
from transformerupscaler_torch import kernels as K
from transformerupscaler_torch.kernels.gmha import global_mha, global_mha_plain
from transformerupscaler_torch.ops.attention import multihead_attention

TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(rng, b, n, c):
    return [rng.standard_normal((b, n, c)).astype(np.float32)
            for _ in range(3)]


# N = 200 is the JAX test's shape: no multiple of the TPU's 128-key padding
# nor of the CUDA kernel's 64-key tile. The last case has heads of 8.
@pytest.mark.parametrize("b,n,c,heads", [(1, 200, 64, 4), (2, 70, 128, 8),
                                         (1, 33, 32, 4)])
def test_global_mha_plain_matches_pallas(rng, b, n, c, heads):
    q, k, v = _qkv(rng, b, n, c)
    want = np.asarray(jax_global_mha(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), heads, interpret=True))
    got = global_mha_plain(*(torch.from_numpy(t) for t in (q, k, v)), heads)
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_global_mha_bf16_close_to_pallas(rng):
    """bf16 inputs: both sides round p and the output to bf16 but sum in
    different orders (the TPU body over a padded 256-key strip), so single
    elements land one bf16 step apart: outputs are averages of |v| < 5, so
    max abs <= 2^-6; mean abs <= 1e-3."""
    b, n, c, heads = 1, 200, 128, 8
    q, k, v = _qkv(rng, b, n, c)
    want = np.asarray(jax_global_mha(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)), heads,
        interpret=True).astype(jnp.float32))
    got = global_mha_plain(*(torch.from_numpy(t).bfloat16()
                             for t in (q, k, v)), heads)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 2.0 ** -6 and err.mean() <= 1e-3, (err.max(),
                                                           err.mean())


def _mha_params(rng, c):
    return [rng.standard_normal(s).astype(np.float32) * 0.1
            for s in ((c, 3 * c), (3 * c,), (c, c), (c,))]


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused2"])
def test_multihead_attention_matches_jax(rng, impl):
    """Both branches of the port against both branches of the JAX op: "xla"
    is the eager form, every other value goes through the kernel's wrapper
    (the Pallas kernel in JAX, its plain version here on the CPU)."""
    b, n, c, heads = 1, 200, 64, 4
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    p = _mha_params(rng, c)
    want = np.asarray(jax_multihead_attention(
        jnp.asarray(x), *(jnp.asarray(t) for t in p), num_heads=heads,
        impl=impl))
    got = multihead_attention(torch.from_numpy(x),
                              *(torch.from_numpy(t) for t in p), heads, impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_multihead_attention_bf16_branches_agree(rng):
    """bf16: the kernel branch and the eager branch round at the same points
    (q scaled in bf16, f32 softmax, p in bf16) up to the f32 accumulation of
    p v, which the eager branch leaves to a bf16 product: max abs <= 2^-6
    at outputs below 2; mean abs <= 2e-3."""
    b, n, c, heads = 1, 150, 64, 4
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    p = [torch.from_numpy(t) for t in _mha_params(rng, c)]
    a = multihead_attention(x.bfloat16(), *p, heads, "pallas").float()
    e = multihead_attention(x.bfloat16(), *p, heads, "xla").float()
    err = (a - e).abs()
    assert err.max() <= 2.0 ** -6 and err.mean() <= 2e-3, (err.max(),
                                                           err.mean())


def test_wrapper_on_cpu_is_the_plain_version_and_takes_slices(rng):
    """The wrapper takes the three channel slices of a packed qkv tensor
    uncopied; on CPU tensors it runs the plain version and launches
    nothing."""
    c, heads = 32, 2
    qkv = torch.from_numpy(rng.standard_normal((1, 50, 3 * c))
                           .astype(np.float32))
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    K.reset_launches()
    got = global_mha(q, k, v, heads)
    assert K.LAUNCHES["global_mha"] == 0 and got.is_contiguous()
    torch.testing.assert_close(
        got, global_mha_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                              heads), rtol=0, atol=0)
