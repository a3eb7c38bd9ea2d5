"""The JAX output fixture that chip_smoke.py holds the port to on the card,
where there is no JAX: its generator and its freshness check.

tests/fixtures/torch_port/slice_x2_bf16.npz holds the seed, the 16x32 input
and the bf16 output of the JAX FastTransformer(compose_tails=True,
pallas_serve=True, split_tail=False) at full model width, x2 with the
squash (res_out 24x48), with weights from ``seeded_params(model, seed)``.
Regenerate with ``PYTHONPATH=. python tests/test_torch_fixtures.py`` from
the repo root.
"""

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_port", "slice_x2_bf16.npz")
SEED, IN_HW, RES_OUT = 7, (16, 32), (24, 48)


def _model_and_tree(dtype):
    from transformerupscaler_torch.registry import get_model
    from transformerupscaler_torch.weights import params_from_jax, seeded_params

    model = get_model("FastTransformer", device="cpu", dtype=dtype)
    tree = seeded_params(model, SEED)
    params_from_jax(model, tree)
    return model, tree


def jax_fixture() -> dict:
    import jax.numpy as jnp
    import torch

    from transformerupscaler_tpu.registry import get_model as jax_get_model

    _, tree = _model_and_tree(torch.bfloat16)
    x = np.random.default_rng(SEED).random((1, *IN_HW, 3)).astype(np.float32)
    jm = jax_get_model("FastTransformer", dtype=jnp.bfloat16,
                       compose_tails=True, pallas_serve=True, split_tail=False)
    y = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), res_out=RES_OUT),
                   np.float32)
    return dict(seed=np.int64(SEED), x=x, y=y,
                res_out=np.asarray(RES_OUT, np.int64))


def test_fixture_is_fresh():
    """The committed JAX output equals what the JAX model gives now."""
    with np.load(FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    fresh = jax_fixture()
    assert set(stored) == set(fresh)
    for k in fresh:
        np.testing.assert_allclose(stored[k], fresh[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def test_port_on_cpu_matches_fixture():
    """The check chip_smoke.py makes on the card, here with the plain
    versions: bf16 interior max abs <= 3e-2, mean abs <= 3e-3 (as in
    test_torch_fast_transformer.py)."""
    import torch

    with np.load(FIXTURE) as f:
        x, y = f["x"], f["y"]
    model, _ = _model_and_tree(torch.bfloat16)
    got = model(torch.from_numpy(x), res_out=RES_OUT).float().numpy()
    err = np.abs(got - y)[:, 4:-4, 4:-4]
    assert err.max() <= 3e-2 and err.mean() <= 3e-3, (err.max(), err.mean())


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **jax_fixture())
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")
