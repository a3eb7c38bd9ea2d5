"""The port's meshes (transformerupscaler_torch/parallel/) on the CPU: one
process driving a mesh whose devices repeat the CPU.

- ``make_mesh`` shapes and errors, as tests/test_sharding.py holds JAX's;
- ``ShardedUpscaler`` on [cpu, cpu] against the engine, b = 8 and 5 (the
  zero padding and the crop), f32 at the parity bound, a uint8 batch cast
  undivided as JAX casts it; against JAX's ``ShardedUpscaler`` on a
  one-device CPU mesh, uint8 and float batches, f32 and bf16;
- head sharding (``activation_sharding`` / ``maybe_shard_heads``) against
  no context: window and global attention, forward and gradients;
- ``Trainer`` on 2x1 and 2x2 meshes against the single-device step (f32,
  dropout 0): the loss and the checksums of the gradient, the parameters
  after the Adam step and the step, at chip_smoke.py's ``TRAIN_TOL``;
- where each replica, shard and head group was placed. On a mesh of one
  repeated device a tensor left on the wrong replica would still compute,
  so placement is asserted explicitly: a run on two distinct cards is what
  these checks stand in for.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch.ops.attention import (
    multihead_attention,
    window_attention,
)
from transformerupscaler_torch.parallel import context as C
from transformerupscaler_torch.parallel.batch_infer import ShardedUpscaler
from transformerupscaler_torch.parallel.mesh import Mesh, cli_mesh, make_mesh
from transformerupscaler_torch import train_lib
from transformerupscaler_torch.train_lib import Trainer
from transformerupscaler_torch.weights import flatten, params_from_jax, \
    seeded_params

CPU = torch.device("cpu")
F32 = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
RESID_SMALL = dict(transformer_dim=32, num_transformer_blocks=2, num_heads=2,
                   token_hw=(2, 4))


# ------------------------------------------------------------------- mesh
def test_mesh_shapes():
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 8, "model": 1}
    mesh = make_mesh(8, tp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices.shape == (4, 2) and mesh.axis_names == ("data",
                                                                "model")
    assert all(d == CPU for d in mesh.devices.flat)
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(8, tp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="requested 100 devices, have 8"):
        make_mesh(100, devices=["cpu"] * 8)
    assert cli_mesh(2, 2, "cpu").shape == {"data": 1, "model": 2}
    assert cli_mesh(-1, 1, "cpu").shape == {"data": 1, "model": 1}


def test_default_mesh_is_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default devices are valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_mesh(2)


# ---------------------------------------------------------- sharded serve
@pytest.mark.parametrize("b", [8, 5])
def test_sharded_upscaler_matches_the_engine(b):
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    model_kw = dict(SMALL)
    engine = UpscalerEngine("FastTransformer", device="cpu",
                            root="/nonexistent", **model_kw)
    params = seeded_params(engine.model, 3)
    params_from_jax(engine.model, params)
    up = ShardedUpscaler("FastTransformer", mesh, params=params,
                         dtype=torch.float32, **model_kw)
    assert len(up.replicas) == 2
    for i, model in enumerate(up.replicas):
        assert all(p.device == mesh.devices[i, 0]
                   for p in model.parameters())
    rng = np.random.default_rng(b)
    batch = rng.integers(0, 256, (b, 16, 32, 3), np.uint8)
    outs = up.upscale_batch(batch, (32, 64))
    per = -(-b // 2)
    assert [o.shape[0] for o in outs] == [per, b - per]
    for i, o in enumerate(outs):
        assert o.device == mesh.devices[i, 0] and o.dtype == torch.float32
    # uint8 is cast as JAX casts it (``jnp.asarray(batch, dtype)``): the
    # model sees 0..255, not divided.
    got = torch.cat(outs).numpy()
    with torch.inference_mode():
        cast = engine.model(torch.from_numpy(batch).float(),
                            res_out=(32, 64)).numpy()
    np.testing.assert_allclose(got, cast, **F32)
    # Float frames in [0, 1] are taken as given.
    want = engine.upscale(batch, res_out=(32, 64))
    got = torch.cat(up.upscale_batch(batch / np.float32(255.0),
                                     (32, 64))).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ShardedUpscaler outputs on a one-device CPU mesh, FastTransformer
    at dim 32 on the seeded weights, by (dtype, input kind)."""
    import jax
    import jax.numpy as jnp
    from transformerupscaler_tpu.parallel.batch_infer import (
        ShardedUpscaler as JaxSharded,
    )
    from transformerupscaler_tpu.parallel.mesh import make_mesh as jax_mesh

    tree = seeded_params(_small_fast("cpu", torch.float32), 4)
    mesh = jax_mesh(1, devices=jax.devices("cpu"))
    out = {}
    for dt in ("float32", "bfloat16"):
        up = JaxSharded("FastTransformer", mesh, params={"params": tree},
                        dtype=jnp.dtype(dt), **SMALL)
        for kind, batch in _sharded_batches().items():
            out[dt, kind] = np.asarray(up.upscale_batch(batch, (32, 64)),
                                       np.float32)
    return tree, out


def _small_fast(device, dtype):
    from transformerupscaler_torch.registry import get_model

    return get_model("FastTransformer", device=device, dtype=dtype, **SMALL)


def _sharded_batches() -> dict:
    u8 = np.random.default_rng(11).integers(0, 256, (2, 16, 32, 3), np.uint8)
    return {"uint8": u8, "float": u8 / np.float32(255.0)}


# uint8 frames reach the model as 0..255, 255 times the range the parity
# bounds were set for, and every rounding of the activations grows with
# them: f32 sums in another order reach 1.3e-4 (atol 5e-4); in bf16 each
# side's output lies 0.60 max / 1.6e-3 mean from its own f32 output, and
# the two sides 0.068 / 3.9e-4 apart (interior max 0.1, mean the bf16
# limit). Float frames in [0, 1] keep the parity bounds.
SHARDED_TOL = {("float32", "float"): (F32, None),
               ("float32", "uint8"): (dict(atol=5e-4, rtol=1e-4), None),
               ("bfloat16", "float"): (None, (3e-2, 3e-3)),
               ("bfloat16", "uint8"): (None, (0.1, 3e-3))}


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_upscaler_matches_jax(jax_sharded, dtype, kind):
    """The port's ShardedUpscaler against JAX's on a one-device CPU mesh,
    the same seeded weights: uint8 cast to the dtype undivided, floats cast
    to the dtype (bf16-rounded frames under bf16). f32 on the whole frame,
    bf16 on the interior (a 4-pixel border cut, as
    tests/test_torch_fast_transformer_bf16.py), at ``SHARDED_TOL``."""
    tree, want = jax_sharded
    up = ShardedUpscaler("FastTransformer", make_mesh(1, devices=["cpu"]),
                         params=tree, dtype=getattr(torch, dtype), **SMALL)
    (out,) = up.upscale_batch(_sharded_batches()[kind], (32, 64))
    got = out.float().numpy()
    want = want[dtype, kind]
    assert got.shape == want.shape == (2, 32, 64, 3)
    # Not all clipped (0..255 frames leave ~3% of the output inside).
    assert np.mean((want > 0) & (want < 1)) > (0.01 if kind == "uint8"
                                               else 0.1)
    whole, interior = SHARDED_TOL[dtype, kind]
    if whole is not None:
        np.testing.assert_allclose(got, want, **whole)
    else:
        err = np.abs(got - want)[:, 4:-4, 4:-4]
        assert err.max() <= interior[0] and err.mean() <= interior[1], (
            err.max(), err.mean())


def test_sharded_upscaler_pads_a_batch_smaller_than_the_mesh():
    mesh = make_mesh(4, devices=["cpu"] * 4)
    up = ShardedUpscaler("BicubicInterpolation", mesh, dtype=torch.float32)
    x = np.random.default_rng(0).random((1, 8, 8, 3), np.float32)
    outs = up.upscale_batch(x, (16, 16))
    assert [o.shape[0] for o in outs] == [1, 0, 0, 0]
    assert outs[0].shape == (1, 16, 16, 3)


# ---------------------------------------------------------- head sharding
def _attn_inputs(seed, c=32, n=16, b=3, heads=4):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).requires_grad_(True)

    x = r(b, n, c)
    return x, [r(c, 3 * c, s=c ** -0.5), r(3 * c, s=0.1),
               r(c, c, s=c ** -0.5), r(c, s=0.1)], heads


@pytest.mark.parametrize("op", ["window", "global"])
@pytest.mark.parametrize("tp", [2, 4])
def test_head_sharding_equals_no_context(op, tp):
    x, w, heads = _attn_inputs(tp)
    table = (torch.randn(49, heads, generator=torch.Generator().manual_seed(
        9)) * 0.02).requires_grad_(True)

    def run():
        if op == "window":
            return window_attention(x, *w, table, heads, 4)
        return multihead_attention(x, *w, heads)

    leaves = [x, *w] + ([table] if op == "window" else [])
    want = run()
    want_g = torch.autograd.grad(want.square().sum(), leaves)
    mesh = make_mesh(2 * tp, tp=tp, devices=["cpu"] * (2 * tp))
    with C.activation_sharding(mesh, row=1) as ctx:
        got = run()
    got_g = torch.autograd.grad(got.square().sum(), leaves)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    # q, k, v (and the window bias) each cut into tp groups, group j on
    # the j-th device of data row 1.
    n_cut = 4 if op == "window" else 3
    assert ctx.placements == [(j, mesh.devices[1, j]) for _ in range(n_cut)
                              for j in range(tp)]


def test_head_sharding_off_a_context_and_at_one_group():
    x = torch.randn(2, 4, 8, 16)
    assert C.maybe_shard_heads(x) is x
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with C.activation_sharding(mesh):
        assert C.maybe_shard_heads(x) is x
    with C.activation_sharding(make_mesh(3, tp=3, devices=["cpu"] * 3)):
        with pytest.raises(ValueError, match="4 heads do not split into 3"):
            C.maybe_shard_heads(x)


# ---------------------------------------------------------------- trainer
def _batch(seed, lr_hw, hrs):
    rng = np.random.default_rng(seed)
    return [(rng.random((*lr_hw, 3), np.float32),
             rng.random((*h, 3), np.float32)) for h in hrs]


CASES = {
    "FastTransformer": (SMALL, (16, 32), ((32, 64), (32, 64), (24, 48))),
    "ResidualTransformer": (RESID_SMALL, (32, 64), ((64, 128), (64, 128),
                                                     (48, 96))),
}


def _step(name, mesh, params, samples):
    kw, _, _ = CASES[name]
    tr = Trainer(name, device=None if mesh else "cpu", mesh=mesh,
                 dtype=torch.float32, dropout=0.0, **kw)
    params_from_jax(tr.model, params)
    tr.set_opt_state(None)
    before = flatten(tr.params())
    loss = tr.train_step(samples)
    grads = {k: p.grad.numpy().copy() for k, p in tr.names.items()}
    return tr, loss, chip_smoke.train_checksums(
        before, grads, flatten(tr.params()), 0)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_mesh_step_equals_the_single_device_step(name, shape, monkeypatch):
    kw, lr_hw, hrs = CASES[name]
    samples = _batch(1, lr_hw, hrs)
    params = seeded_params(
        Trainer(name, device="cpu", dropout=0.0, **kw).model, 5)
    _, loss, fix = _step(name, None, params, samples)
    fix["loss"] = loss

    contexts = []
    real = train_lib.activation_sharding

    def spy(mesh, **kwargs):
        cm = real(mesh, **kwargs)
        contexts.append(kwargs.get("row"))
        return cm

    monkeypatch.setattr(train_lib, "activation_sharding", spy)
    mesh = make_mesh(shape[0] * shape[1], tp=shape[1],
                     devices=["cpu"] * (shape[0] * shape[1]))
    tr, got_loss, got = _step(name, mesh, params, samples)
    errors = chip_smoke.train_step_errors(got, got_loss, fix)
    for kind, err in errors.items():
        assert err <= chip_smoke.TRAIN_TOL[kind], (kind, errors)
    assert len(tr.replicas) == 2 and tr.model is tr.replicas[0]
    for i, model in enumerate(tr.replicas):
        assert all(p.device == mesh.devices[i, 0]
                   for p in model.parameters())
    # Head sharding only with a model axis: per bucket, one context a
    # replica, on its own data row.
    assert contexts == ([0, 1] * 2 if shape[1] > 1 else [])


def test_mesh_step_with_dropout_draws_from_one_generator():
    kw, lr_hw, hrs = CASES["FastTransformer"]
    mesh = make_mesh(4, tp=2, devices=["cpu"] * 4)
    tr = Trainer("FastTransformer", mesh=mesh, dtype=torch.float32,
                 dropout=0.1, **kw)
    tr.init_params()
    losses = [tr.train_step(_batch(2, lr_hw, hrs),
                            torch.Generator().manual_seed(0))
              for _ in range(2)]
    assert np.isfinite(losses).all()
    # Each step starts from the primary's parameters on every replica.
    pre = [p.detach().clone() for p in tr.model.parameters()]
    tr.train_step(_batch(3, lr_hw, hrs), torch.Generator().manual_seed(1))
    for a, b in zip(pre, tr.replicas[1].parameters()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        pre, tr.model.parameters()))


def test_trainer_mesh_argument_checks():
    with pytest.raises(TypeError, match="Mesh"):
        Trainer("WindowTransformer", device="cpu", mesh=object())
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="first device"):
        Trainer("WindowTransformer", device="meta", mesh=mesh, **SMALL)


# ------------------------------------------------------- batch of frames
def _bench_small():
    from transformerupscaler_torch.registry import get_model

    model = get_model("FastTransformer", device="cpu", dtype=torch.bfloat16,
                      **chip_smoke.ROUTE_BENCH, **SMALL)
    params_from_jax(model, seeded_params(model, 3))
    x = torch.from_numpy(np.random.default_rng(0).random((3, 16, 32, 3),
                                                         np.float32))
    return model, x


def test_batch_split_on_the_plain_versions():
    """chip_smoke.py's batch checks on the CPU (the wrappers' plain
    versions): every stage of the bench route is recorded, in order, and
    none depends on the other frames of its batch."""
    model, x = _bench_small()
    split = chip_smoke.batch_split(model, x, (24, 48))
    stages = [r["stage"] for r in split]
    assert stages == ["conv2d", "conv3x3_stream", "tail_conv_stream",
                      "embed_stream", "run_trunk", "unembed_combine_stream",
                      "conv3x3_stream", "tail_finish_stream",
                      "resize_shuffled"]
    assert all(r["equal"] for r in split)
    divergence = chip_smoke.stage_divergence(model, x, (24, 48))
    assert [r["stage"] for r in divergence] == stages
    assert all(r["equal"] for r in divergence)
    assert "run_trunk" not in model.__dict__  # the recorder put it back


def test_batch_split_names_a_stage_that_reads_its_batch(monkeypatch):
    """A stage whose output for one frame depends on its batch (here the
    tail, shifted by the batch's mean) is the one both checks name."""
    from transformerupscaler_torch.models import fast_transformer as FT

    model, x = _bench_small()
    real = FT.tail_conv_stream
    monkeypatch.setattr(FT, "tail_conv_stream",
                        lambda feat, *a, **k: real(feat, *a, **k)
                        + feat.float().mean().to(feat.dtype))
    split = chip_smoke.batch_split(model, x, (24, 48))
    assert [r["stage"] for r in split if not r["equal"]] == [
        "tail_conv_stream"]
    divergence = chip_smoke.stage_divergence(model, x, (24, 48))
    first = next(r for r in divergence if not r["equal"])
    assert first["stage"] == "tail_conv_stream" and first["kernel"]
