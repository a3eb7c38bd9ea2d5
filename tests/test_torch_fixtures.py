"""The JAX output fixtures that chip_smoke.py holds the port to on the card,
where there is no JAX: their generator and their freshness checks.

Each file under tests/fixtures/torch_port/ holds a seed, an input and the
bf16 output of the JAX FastTransformer(compose_tails=True, pallas_serve=True,
...) at full model width, x2 with the squash, with weights from
``seeded_params(model, seed)``:

- slice_x2_bf16.npz: ``split_tail=False`` (and the XLA trunk), 16x32 ->
  24x48;
- bench_x2_bf16.npz: ``attn_impl="fused2"`` with the automatic split tail,
  the configuration bench.py runs, 24x144 -> 36x216: a 3x18 token grid, which
  is not a window multiple and pads to three windows.

Regenerate with ``PYTHONPATH=. python tests/test_torch_fixtures.py`` from
the repo root.
"""

import os

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "torch_port")
FIXTURE = os.path.join(DIR, "slice_x2_bf16.npz")
SEED, IN_HW, RES_OUT = 7, (16, 32), (24, 48)
ROUTE = dict(split_tail=False)
BENCH_FIXTURE = os.path.join(DIR, "bench_x2_bf16.npz")
BENCH_IN_HW, BENCH_RES_OUT = (24, 144), (36, 216)
BENCH_ROUTE = dict(attn_impl="fused2")


def _model_and_tree(dtype, route=ROUTE):
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    model = get_model("FastTransformer", device="cpu", dtype=dtype,
                      compose_tails=True, pallas_serve=True, **route)
    tree = seeded_params(model, SEED)
    params_from_jax(model, tree)
    return model, tree


def jax_fixture(route=ROUTE, in_hw=IN_HW, res_out=RES_OUT) -> dict:
    import jax.numpy as jnp
    import torch

    from transformerupscaler_tpu.registry import get_model as jax_get_model

    _, tree = _model_and_tree(torch.bfloat16, route)
    x = np.random.default_rng(SEED).random((1, *in_hw, 3)).astype(np.float32)
    jm = jax_get_model("FastTransformer", dtype=jnp.bfloat16,
                       compose_tails=True, pallas_serve=True, **route)
    y = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), res_out=res_out),
                   np.float32)
    return dict(seed=np.int64(SEED), x=x, y=y,
                res_out=np.asarray(res_out, np.int64))


def _assert_fresh(path, fresh):
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files}
    assert set(stored) == set(fresh)
    for k in fresh:
        np.testing.assert_allclose(stored[k], fresh[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def _assert_port_matches(path, route, res_out):
    """The check chip_smoke.py makes on the card, here with the plain
    versions: bf16 interior max abs <= 3e-2, mean abs <= 3e-3 (as in
    test_torch_fast_transformer.py)."""
    import torch

    with np.load(path) as f:
        x, y = f["x"], f["y"]
    model, _ = _model_and_tree(torch.bfloat16, route)
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


if __name__ == "__main__":
    for path, args in ((FIXTURE, ()),
                       (BENCH_FIXTURE,
                        (BENCH_ROUTE, BENCH_IN_HW, BENCH_RES_OUT))):
        np.savez_compressed(path, **jax_fixture(*args))
        print("wrote", path, os.path.getsize(path), "bytes")
