"""The route bench.py runs, end to end on the CPU: the port's FastTransformer
with ``attn_impl="fused2"`` and the automatic split tail against the JAX
model in the same configuration (Pallas kernels in interpret mode), with
the set-up of test_torch_fast_transformer.py: a small trunk (dim 32, 2
heads of 16, 2 blocks), the same seeded weights on both sides, a 16x32
input.

bf16: the interior (a 2*scale ring cropped) must agree to max abs <= 3e-2
and mean abs <= 3e-3, as for the first route. The border ring is excluded
because it is where the frameworks' bf16 roundings meet the fewest taps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

from test_torch_fast_transformer import GEOMETRIES, GEOMETRY_IDS, SMALL

ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
X = np.random.default_rng(1).random((1, 16, 32, 3)).astype(np.float32)


def _port(dtype, **route):
    model = get_model("FastTransformer", device="cpu", dtype=dtype,
                      **{**ROUTE, **route}, **SMALL)
    tree = seeded_params(model, 3)
    params_from_jax(model, tree)
    return model, tree


@pytest.mark.parametrize("call", GEOMETRIES, ids=GEOMETRY_IDS)
def test_bench_route_bf16_matches_jax(call):
    model, tree = _port(torch.bfloat16)
    assert model.splits_tail
    jm = jax_get_model("FastTransformer", dtype=jnp.bfloat16, **ROUTE, **SMALL)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(X), **call),
                      np.float32)
    got = model(torch.from_numpy(X), **call).float().numpy()
    assert got.shape == want.shape
    c = 2 * (call.get("upscale_factor") or 2)
    err = np.abs(got - want)[:, c:-c, c:-c]
    assert err.max() <= 3e-2, err.max()
    assert err.mean() <= 3e-3, err.mean()


@pytest.mark.parametrize("dtype,explicit", [(torch.bfloat16, True),
                                            (torch.float32, False)],
                         ids=["bf16-auto-splits", "f32-auto-folds"])
def test_auto_split_rule(dtype, explicit):
    """``split_tail=None`` splits the B tail at bf16 and folds it at f32:
    the output is bit-identical to the explicit choice."""
    auto, _ = _port(dtype)
    fixed, _ = _port(dtype, split_tail=explicit)
    assert auto.splits_tail is explicit
    x = torch.from_numpy(X)
    torch.testing.assert_close(auto(x, res_out=(24, 48)),
                               fixed(x, res_out=(24, 48)), atol=0, rtol=0)
    other, _ = _port(dtype, split_tail=not explicit)
    assert not torch.equal(other(x, res_out=(24, 48)),
                           fixed(x, res_out=(24, 48)))


def test_hi_lo_fin_reaches_the_split_tail():
    """The finish modes differ only in rounding: outputs are close and not
    identical."""
    x = torch.from_numpy(X)
    outs = {}
    for mode in (None, "off", "wf", "full"):
        model, _ = _port(torch.bfloat16, hi_lo_fin=mode)
        outs[mode] = model(x, upscale_factor=2).float()
    assert torch.equal(outs[None], outs["off"])
    assert not torch.equal(outs["off"], outs["full"])
    torch.testing.assert_close(outs["off"], outs["full"], atol=2e-2, rtol=0)
    with pytest.raises(ValueError, match="hi_lo_fin"):
        _port(torch.bfloat16, hi_lo_fin="hi")
