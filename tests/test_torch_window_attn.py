"""The window-attention core's plain version
(transformerupscaler_torch/kernels/window_attn.py) and the port's
``window_attention(impl="pallas")`` against the JAX Pallas kernel
``fused_window_attention`` in interpret mode and against the JAX XLA op, on
the CPU. f32 tolerance: atol=1e-4, rtol=1e-4, as the JAX kernel tests use
between Pallas and XLA; bf16 bounds are stated at the test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.ops.attention import (
    window_attention as jax_window_attention,
)
from transformerupscaler_tpu.ops.pallas.window_attn import (
    fused_window_attention,
)
from transformerupscaler_tpu.ops.relpos import (
    gather_relative_bias as jax_gather_relative_bias,
)
from transformerupscaler_torch import kernels as K
from transformerupscaler_torch.kernels.window_attn import (
    window_attention_core,
    window_attention_plain,
)
from transformerupscaler_torch.models.common import (
    TRUNK_IMPLS,
    WindowBlock,
    run_window_trunk,
)
from transformerupscaler_torch.ops.attention import window_attention

TOL = dict(atol=1e-4, rtol=1e-4)


def _params(rng, c, heads, ws):
    return dict(
        qkv_w=rng.standard_normal((c, 3 * c)).astype(np.float32) * 0.1,
        qkv_b=rng.standard_normal(3 * c).astype(np.float32) * 0.1,
        proj_w=rng.standard_normal((c, c)).astype(np.float32) * 0.1,
        proj_b=rng.standard_normal(c).astype(np.float32) * 0.1,
        bias_table=rng.standard_normal(
            ((2 * ws - 1) ** 2, heads)).astype(np.float32) * 0.5)


def _port(x, p, heads, ws, impl, dtype=torch.float32):
    args = [torch.from_numpy(p[k]) for k in
            ("qkv_w", "qkv_b", "proj_w", "proj_b", "bias_table")]
    return window_attention(torch.from_numpy(x).to(dtype), *args, heads, ws,
                            impl).float().numpy()


def _jax(x, p, heads, ws, pallas, dtype=jnp.float32):
    args = [jnp.asarray(p[k]) for k in
            ("qkv_w", "qkv_b", "proj_w", "proj_b", "bias_table")]
    xj = jnp.asarray(x).astype(dtype)
    if pallas:
        out = fused_window_attention(xj, *args, num_heads=heads,
                                     window_size=ws, interpret=True)
    else:
        out = jax_window_attention(xj, *args, num_heads=heads, window_size=ws)
    return np.asarray(out.astype(jnp.float32))


# (windows, heads, window size, C): the WindowTransformer and FastTransformer
# widths, and the small-head case of tests/test_pallas.py (hd = 8).
CASES = [(5, 8, 8, 128), (3, 12, 8, 192), (7, 4, 4, 32)]


@pytest.mark.parametrize("nw,heads,ws,c", CASES)
def test_window_attention_pallas_matches_jax_pallas(rng, nw, heads, ws, c):
    x = rng.standard_normal((nw, ws * ws, c)).astype(np.float32)
    p = _params(rng, c, heads, ws)
    np.testing.assert_allclose(_port(x, p, heads, ws, "pallas"),
                               _jax(x, p, heads, ws, True), **TOL)


@pytest.mark.parametrize("nw,heads,ws,c", CASES)
def test_window_attention_pallas_matches_jax_xla(rng, nw, heads, ws, c):
    x = rng.standard_normal((nw, ws * ws, c)).astype(np.float32)
    p = _params(rng, c, heads, ws)
    want = _jax(x, p, heads, ws, False)
    np.testing.assert_allclose(_port(x, p, heads, ws, "pallas"), want, **TOL)
    np.testing.assert_allclose(_port(x, p, heads, ws, "xla"), want, **TOL)


def test_window_attention_plain_matches_pallas_core(rng):
    """The core alone, without the projections around it: the same qkv goes
    into the port's plain version and, transposed to the TPU's (C, N)
    layout with q scaled, into the Pallas call."""
    import jax
    from jax.experimental import pallas as pl

    from transformerupscaler_tpu.ops.pallas.window_attn import _attn_kernel

    nw, heads, ws, c = 4, 8, 8, 128
    n = ws * ws
    qkv = rng.standard_normal((nw, n, 3 * c)).astype(np.float32)
    table = rng.standard_normal(((2 * ws - 1) ** 2, heads)).astype(np.float32)
    bias = np.array(jax_gather_relative_bias(jnp.asarray(table), ws))
    t = jnp.asarray(qkv).reshape(nw, n, 3, c).transpose(2, 0, 3, 1)
    want = pl.pallas_call(
        lambda q, k, v, b, o: _attn_kernel(q, k, v, b, o, num_heads=heads),
        out_shape=jax.ShapeDtypeStruct((nw, c, n), jnp.float32),
        grid=(nw,),
        in_specs=[pl.BlockSpec((1, c, n), lambda w: (w, 0, 0))] * 3
        + [pl.BlockSpec((heads, n, n), lambda w: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, c, n), lambda w: (w, 0, 0)),
        interpret=True)(t[0] * (c // heads) ** -0.5, t[1], t[2],
                        jnp.asarray(bias))
    got = window_attention_plain(torch.from_numpy(qkv),
                                 torch.from_numpy(bias), heads)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1), **TOL)


def test_window_attention_bf16_close_to_jax_pallas(rng):
    """bf16: both sides round the probabilities and the context to bf16, in
    different summation orders, so single elements land one bf16 step apart
    (2^-7 of values below 2): max abs <= 2^-6, mean abs <= 2e-3."""
    nw, heads, ws, c = 6, 8, 8, 128
    x = rng.standard_normal((nw, ws * ws, c)).astype(np.float32)
    p = _params(rng, c, heads, ws)
    got = _port(x, p, heads, ws, "pallas", torch.bfloat16)
    want = _jax(x, p, heads, ws, True, jnp.bfloat16)
    err = np.abs(got - want)
    assert err.max() <= 2.0 ** -6 and err.mean() <= 2e-3, (err.max(),
                                                           err.mean())


def test_core_wrapper_on_cpu_is_the_plain_version(rng):
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 96)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32))
    K.reset_launches()
    got = window_attention_core(qkv, bias, 2)
    assert K.LAUNCHES["window_attention_core"] == 0
    torch.testing.assert_close(got, window_attention_plain(qkv, bias, 2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        window_attention(qkv[..., :32], *[torch.zeros(1)] * 5, 2, 8, "fused")


def test_run_window_trunk_pallas_matches_xla_blocks(rng):
    """``impl="pallas"`` reaches every block's attention and, on the CPU,
    gives the XLA-route result on a padded grid (3 x 10 tokens)."""
    assert "pallas" in TRUNK_IMPLS
    blocks = [WindowBlock(32, 8, 2) for _ in range(2)]
    for blk in blocks:
        for name, prm in blk.named_parameters():
            z = torch.from_numpy(rng.standard_normal(tuple(prm.shape))
                                 .astype(np.float32))
            prm.copy_(1.0 + 0.1 * z if name.endswith("scale") else 0.2 * z)
    tokens = torch.from_numpy(
        rng.standard_normal((1, 3, 10, 32)).astype(np.float32))
    got = run_window_trunk(tokens, blocks, 8, "pallas")
    want = run_window_trunk(tokens, blocks, 8, "xla")
    torch.testing.assert_close(got, want, **TOL)
