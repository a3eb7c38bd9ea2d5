"""The JAX output fixtures that chip_smoke.py holds the port to on the card,
where there is no JAX: their generator and their freshness checks.

Each file under tests/fixtures/torch_port/ holds a seed, an input and the
bf16 output of a JAX model at full model width on one served route, with
weights from ``seeded_params(model, seed)``. FastTransformer(
compose_tails=True, pallas_serve=True, ...), x2 with the squash:

- slice_x2_bf16.npz: ``split_tail=False`` (and the XLA trunk), 16x32 ->
  24x48;
- bench_x2_bf16.npz: ``attn_impl="fused2"`` with the automatic split tail,
  the configuration bench.py runs, 24x144 -> 36x216: a 3x18 token grid, which
  is not a window multiple and pads to three windows.

The other models (``NEW_FIXTURES``):

- window_pallas_bf16.npz: WindowTransformer(pallas_serve=True,
  attn_impl="pallas"), 64x144 -> 96x216: a 4x9 token grid, which pads to two
  windows;
- resid_packed_x2_bf16.npz: ResidualTransformer(packed_serve=True,
  pallas_serve=True, attn_impl="fused2", token_hw=(4, 6)), 64x96 -> 128x192:
  24 tokens, less than one key tile of the attention kernel.

Regenerate with ``PYTHONPATH=. python tests/test_torch_fixtures.py`` from
the repo root.
"""

import contextlib
import functools
import os

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")
FIXTURE = os.path.join(DIR, "slice_x2_bf16.npz")
SEED, IN_HW, RES_OUT = 7, (16, 32), (24, 48)
ROUTE = dict(split_tail=False)
BENCH_FIXTURE = os.path.join(DIR, "bench_x2_bf16.npz")
BENCH_IN_HW, BENCH_RES_OUT = (24, 144), (36, 216)
BENCH_ROUTE = dict(attn_impl="fused2")
# name -> (file, model, route, input size, res_out)
NEW_FIXTURES = {
    "window_pallas": (
        os.path.join(DIR, "window_pallas_bf16.npz"), "WindowTransformer",
        dict(pallas_serve=True, attn_impl="pallas"), (64, 144), (96, 216)),
    "resid_packed": (
        os.path.join(DIR, "resid_packed_x2_bf16.npz"), "ResidualTransformer",
        dict(packed_serve=True, pallas_serve=True, attn_impl="fused2",
             token_hw=(4, 6)), (64, 96), (128, 192)),
}


def _model_and_tree(dtype, route=ROUTE, name="FastTransformer"):
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    if name == "FastTransformer":
        route = dict(compose_tails=True, pallas_serve=True, **route)
    model = get_model(name, device="cpu", dtype=dtype, **route)
    tree = seeded_params(model, SEED)
    params_from_jax(model, tree)
    return model, tree, route


@contextlib.contextmanager
def _interpreted_window_pallas():
    """The JAX ``window_attention(impl="pallas")`` does not pass ``interpret``
    on; put the interpreted kernel in its place, as tests/test_pallas.py
    calls it."""
    from transformerupscaler_tpu.ops.pallas import window_attn

    saved = window_attn.fused_window_attention
    window_attn.fused_window_attention = functools.partial(saved,
                                                           interpret=True)
    try:
        yield
    finally:
        window_attn.fused_window_attention = saved


def jax_fixture(route=ROUTE, in_hw=IN_HW, res_out=RES_OUT,
                name="FastTransformer") -> dict:
    import jax.numpy as jnp
    import torch

    from transformerupscaler_tpu.registry import get_model as jax_get_model

    _, tree, route = _model_and_tree(torch.bfloat16, route, name)
    x = np.random.default_rng(SEED).random((1, *in_hw, 3)).astype(np.float32)
    jm = jax_get_model(name, dtype=jnp.bfloat16, **route)
    with _interpreted_window_pallas():
        y = np.asarray(jm.apply({"params": tree}, jnp.asarray(x),
                                res_out=res_out), np.float32)
    return dict(seed=np.int64(SEED), x=x, y=y,
                res_out=np.asarray(res_out, np.int64))


def _assert_fresh(path, fresh):
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files}
    assert set(stored) == set(fresh)
    for k in fresh:
        np.testing.assert_allclose(stored[k], fresh[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def _assert_port_matches(path, route, res_out, name="FastTransformer"):
    """The check chip_smoke.py makes on the card, here with the plain
    versions: bf16 interior max abs <= 3e-2, mean abs <= 3e-3 (as in
    test_torch_fast_transformer.py)."""
    import torch

    with np.load(path) as f:
        x, y = f["x"], f["y"]
    model, _, _ = _model_and_tree(torch.bfloat16, route, name)
    got = model(torch.from_numpy(x), res_out=res_out).float().numpy()
    err = np.abs(got - y)[:, 4:-4, 4:-4]
    assert err.max() <= 3e-2 and err.mean() <= 3e-3, (err.max(), err.mean())


def test_fixture_is_fresh():
    """The committed JAX output equals what the JAX model gives now."""
    _assert_fresh(FIXTURE, jax_fixture())


def test_port_on_cpu_matches_fixture():
    _assert_port_matches(FIXTURE, ROUTE, RES_OUT)


def test_bench_fixture_is_fresh():
    _assert_fresh(BENCH_FIXTURE,
                  jax_fixture(BENCH_ROUTE, BENCH_IN_HW, BENCH_RES_OUT))


def test_port_on_cpu_matches_bench_fixture():
    _assert_port_matches(BENCH_FIXTURE, BENCH_ROUTE, BENCH_RES_OUT)


@pytest.mark.parametrize("which", sorted(NEW_FIXTURES))
def test_new_model_fixture_is_fresh(which):
    path, name, route, in_hw, res_out = NEW_FIXTURES[which]
    assert os.path.getsize(path) < 300_000
    _assert_fresh(path, jax_fixture(route, in_hw, res_out, name))


@pytest.mark.parametrize("which", sorted(NEW_FIXTURES))
def test_port_on_cpu_matches_new_model_fixture(which):
    path, name, route, _, res_out = NEW_FIXTURES[which]
    _assert_port_matches(path, route, res_out, name)


if __name__ == "__main__":
    jobs = [(FIXTURE, ()),
            (BENCH_FIXTURE, (BENCH_ROUTE, BENCH_IN_HW, BENCH_RES_OUT))]
    jobs += [(path, (route, in_hw, res_out, name))
             for path, name, route, in_hw, res_out in NEW_FIXTURES.values()]
    for path, args in jobs:
        np.savez_compressed(path, **jax_fixture(*args))
        print("wrote", path, os.path.getsize(path), "bytes")
