"""The port's training (transformerupscaler_torch/train_lib.py and the
models in train mode) against the JAX package's ``Trainer`` on the CPU.

At narrow widths (dim 32, 2 blocks, 2 heads), f32, dropout 0, from the
parameters of JAX's ``init_params``, on a batch of two geometries, one
squashed to its target: the loss and every gradient leaf at the f32 parity
bound (atol 5e-5, rtol 1e-4); one Adam step, the step after JAX's first
(JAX's parameters and optax state carried over), and two epochs of ``fit``.
Adam's update is lr * m / (sqrt(v) + eps) with m / sqrt(v) = +-1 on the
first step wherever |g| >> eps = 1e-8, so the updated parameters are held
where |g| > 1e-6 to the f32 rounding of p +- lr (2e-7 + 2^-23 |p|), and
everywhere to a tenth of lr (1e-5): where |g| is within a few eps, a
gradient that differs by its f32 summation order moves m / sqrt(v) by a
part of one. The losses over ``fit`` at the f32 parity bound. One bf16
step's loss within a bf16 step of JAX's bf16 loss on the same batch.

JAX's training semantics (tests/test_train.py) on the port; dropout (rate 0
equals eval mode and JAX; a seeded generator reproduces a mask; each of
JAX's sites drops and no other does, held against JAX with the same masks
on both sides); the initialisers against JAX's ``model.init``; and a model
that serves, trains and serves again in one process.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train.py`` writes
``tests/fixtures/torch_port/train_step_FastTransformer.npz``, which
chip_smoke.py's ``train`` phase holds the card's full-width f32 step to.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.checkpoint import get_latest_checkpoint
from transformerupscaler_torch.data.datasets import HighresImageDataset
from transformerupscaler_torch.models import common as TC
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.train_lib import Trainer
from transformerupscaler_torch.weights import (
    TRUNCATED_UNIT_STD,
    flatten,
    init_params,
    opt_state_from_jax,
    params_from_jax,
    seeded_params,
)
from transformerupscaler_tpu.data.bucketing import bucket_batch as jax_buckets
from transformerupscaler_tpu.registry import get_model as jax_get_model
from transformerupscaler_tpu.train_lib import Trainer as JaxTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "train_step_FastTransformer.npz")
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)
RESID_SMALL = dict(transformer_dim=32, num_transformer_blocks=2, num_heads=2,
                   token_hw=(2, 4))
MODELS = ("FastTransformer", "WindowTransformer")
F32 = dict(atol=5e-5, rtol=1e-4)
LR = 1e-4


def _batch(seed, lr_hw=(16, 32), hr=((32, 64), (32, 64), (24, 48))):
    """Float32 (lr, hr) samples: two of one geometry, the last squashed
    (its model output is 32x64, its target smaller)."""
    rng = np.random.default_rng(seed)
    return [(rng.random((*lr_hw, 3), np.float32),
             rng.random((*h, 3), np.float32)) for h in hr]


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@functools.cache
def jax_init(name):
    """JAX's ``Trainer.init_params`` parameters of ``name`` at narrow width
    (``model.init``, jitted: one compile instead of an eager op-by-op
    init), as numpy."""
    cfg, lr_hw, hr_hw = MODEL_CASES[name]
    model = jax_get_model(name, dtype=jnp.float32, **cfg)
    x = jnp.zeros((1, *lr_hw, 3), jnp.float32)
    init = jax.jit(lambda key: model.init(key, x, res_out=hr_hw,
                                          require_ratio=False)["params"])
    return _np(init(jax.random.PRNGKey(0)))


def jax_apply(model, params, x, res_out, **kw):
    """The model's forward, jitted, ``require_ratio=False``."""
    fn = jax.jit(lambda p, x: model.apply({"params": p}, x, res_out=res_out,
                                          require_ratio=False, **kw))
    return np.asarray(fn(params, jnp.asarray(x)))


def jax_grads(trainer, samples):
    """JAX ``Trainer.train_step``'s gradient, flat by path: each bucket's
    jitted value_and_grad, padded as train_step pads, summed, / n."""
    acc = None
    for (lr_hw, hr_hw), (lrs, hrs) in jax_buckets(samples).items():
        k = lrs.shape[0]
        rows = 1 << max(0, (k - 1).bit_length())
        pad = ((0, rows - k), (0, 0), (0, 0), (0, 0))
        w = np.zeros(rows, np.float32)
        w[:k] = 1.0
        _, g = trainer._bucket_grad_fn(lr_hw, hr_hw, rows)(
            trainer.params, jnp.asarray(np.pad(lrs, pad)),
            jnp.asarray(np.pad(hrs, pad)), jnp.asarray(w),
            jax.random.PRNGKey(0))
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return {k: v / len(samples) for k, v in flatten(_np(acc)).items()}


@pytest.fixture(scope="module", params=MODELS)
def jax_run(request, tmp_path_factory):
    """JAX's Trainer at f32, dropout 0: init, the gradient of one batch,
    two steps on it (parameters and optax state after each), then two
    epochs of ``fit`` on its three samples."""
    name = request.param
    ck = tmp_path_factory.mktemp(f"jax_{name}")
    jt = JaxTrainer(name, checkpoint_dir=str(ck), dtype=jnp.float32,
                    dropout=0.0, **SMALL)
    samples = _batch(0)
    jt.params = jax.tree.map(jnp.asarray, jax_init(name))
    jt.opt_state = jt.optimizer.init(jt.params)
    run = {"name": name, "samples": samples, "p0": _np(jt.params),
           "grads": jax_grads(jt, samples)}
    key = jax.random.PRNGKey(0)
    run["loss1"] = jt.train_step(samples, key)
    run["p1"], run["opt1"] = _np(jt.params), opt_state_from_jax(jt.opt_state)
    run["loss2"] = jt.train_step(samples, key)
    run["p2"], run["opt2"] = _np(jt.params), opt_state_from_jax(jt.opt_state)
    run["fit"] = jt.fit(samples, epochs=2, batch_size=3, log_interval=100,
                        checkpoint_interval=100, resume=False)
    return run


def port_trainer(name, params, opt_state=None, tmp=None, **kw):
    kw = {"dtype": torch.float32, "dropout": 0.0, **SMALL, **kw}
    tr = Trainer(name, checkpoint_dir=str(tmp or "unused"), device="cpu",
                 **kw)
    params_from_jax(tr.model, params)
    tr.set_opt_state(opt_state)
    return tr


def assert_adam_step(got: dict, want: dict, grads: dict):
    """Parameters after an Adam step (module docstring): within the f32
    rounding of p +- lr where |g| > 1e-6, within lr / 10 everywhere."""
    got = flatten(got)
    for path, w in flatten(want).items():
        err = np.abs(got[path] - w)
        big = np.abs(grads[path]) > 1e-6
        assert err.max() <= LR / 10, (path, err.max())
        assert (err[big] <= 2e-7 + 2.0 ** -23 * np.abs(w[big])).all(), path


def test_one_step_matches_jax(jax_run):
    tr = port_trainer(jax_run["name"], jax_run["p0"])
    loss = tr.train_step(jax_run["samples"])
    np.testing.assert_allclose(loss, jax_run["loss1"], **F32)
    for path, p in tr.names.items():
        np.testing.assert_allclose(p.grad.numpy(), jax_run["grads"][path],
                                   err_msg=path, **F32)
    assert_adam_step(tr.params(), jax_run["p1"], jax_run["grads"])
    assert tr.opt_state()["count"] == jax_run["opt1"]["count"] == 1


def test_jax_run_resumes_in_the_port(jax_run):
    """JAX's step-1 parameters and optax state (``opt_state_from_jax``)
    go into the port; its step 2 is JAX's."""
    tr = port_trainer(jax_run["name"], jax_run["p1"], jax_run["opt1"])
    loss = tr.train_step(jax_run["samples"])
    np.testing.assert_allclose(loss, jax_run["loss2"], **F32)
    grads = {k: p.grad.numpy() for k, p in tr.names.items()}
    assert_adam_step(tr.params(), jax_run["p2"], grads)
    opt = tr.opt_state()
    assert opt["count"] == jax_run["opt2"]["count"] == 2
    for moment in ("mu", "nu"):
        want = flatten(jax_run["opt2"][moment])
        for path, v in flatten(opt[moment]).items():
            np.testing.assert_allclose(v, want[path], rtol=1e-4,
                                       atol=1e-4 * np.abs(want[path]).max()
                                       + 1e-12, err_msg=path)


def test_fit_losses_match_jax(jax_run, tmp_path):
    tr = port_trainer(jax_run["name"], jax_run["p2"], jax_run["opt2"],
                      tmp=tmp_path)
    losses = tr.fit(jax_run["samples"], epochs=2, batch_size=3,
                    log_interval=100, checkpoint_interval=100, resume=False)
    np.testing.assert_allclose(losses, jax_run["fit"], **F32)


def _jax_loss(model, params, samples):
    """The mean per-sample L1 of JAX's train step (dropout 0)."""
    from transformerupscaler_tpu.ops.resize import resize_antialias_bilinear

    out = []
    for (lr_hw, hr_hw), (lrs, hrs) in jax_buckets(samples).items():
        y = jnp.asarray(jax_apply(model, params, lrs, hr_hw))
        if y.shape[1:3] != hr_hw:
            y = resize_antialias_bilinear(y, hr_hw)
        out += list(np.abs(np.asarray(y, np.float32) - hrs).mean((1, 2, 3)))
    return float(np.mean(out))


def test_bf16_step_loss_within_bf16_steps(jax_run):
    """The same step in bf16 on both sides: the losses (means of |out -
    hr| in [0, 1]) lie within one bf16 step at 1.0 (2^-8)."""
    name = jax_run["name"]
    tr = port_trainer(name, jax_run["p0"], dtype=torch.bfloat16)
    loss = tr.train_step(jax_run["samples"])
    model = jax_get_model(name, dtype=jnp.bfloat16, dropout=0.0, **SMALL)
    want = _jax_loss(model, jax_run["p0"], jax_run["samples"])
    assert abs(loss - want) <= 2.0 ** -8, (loss, want)
    assert abs(loss - jax_run["loss1"]) <= 2.0 ** -6


# ---------------------------------------------------------- JAX's semantics
class _TinyDataset:
    """tests/test_train.py's: LR = the HR mean-pooled, two geometries."""

    def __init__(self, n=12, seed=0):
        rng = np.random.default_rng(seed)
        self.samples = []
        for i in range(n):
            hw = (16, 16) if i % 3 == 2 else (32, 32)
            hr = rng.random((2 * hw[0], 2 * hw[1], 3)).astype(np.float32)
            lr = hr.reshape(hw[0], 2, hw[1], 2, 3).mean(axis=(1, 3))
            self.samples.append((lr, hr))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _window(tmp, **kw):
    return Trainer("WindowTransformer", checkpoint_dir=str(tmp),
                   dtype=torch.float32, device="cpu", **SMALL, **kw)


def _loss_falls(tmp):
    losses = _window(tmp, learning_rate=1e-3).fit(
        _TinyDataset(), epochs=4, log_interval=100, checkpoint_interval=10,
        resume=False)
    assert len(losses) == 4 and losses[-1] < losses[0]


def _bucketed_equals_per_sample(tmp):
    tr = _window(tmp, dropout=0.0)
    samples = [_TinyDataset(n=5)[i] for i in range(5)]
    tr.init_params()
    fresh = get_model("WindowTransformer", device="cpu", **SMALL)
    params_from_jax(fresh, tr.params())
    manual = [float(np.abs(fresh(torch.from_numpy(lr)[None],
                                 res_out=hr.shape[:2],
                                 require_ratio=False)[0].numpy() - hr).mean())
              for lr, hr in samples]
    assert abs(tr.train_step(samples) - np.mean(manual)) < 1e-6


def _resume(tmp):
    ds = _TinyDataset(n=6)
    _window(tmp).fit(ds, epochs=2, log_interval=100)
    assert get_latest_checkpoint(str(tmp))[1] == 2
    tr = _window(tmp)
    tr.fit(ds, epochs=3, log_interval=100)
    path, epoch = get_latest_checkpoint(str(tmp))
    assert epoch == 3 and path.endswith("model_epoch_3.npz")
    assert tr.opt_state()["count"] == 3  # one batch an epoch, Adam resumed


def _refused_resume_exits_3(tmp):
    _window(tmp).fit(_TinyDataset(n=6), epochs=1, log_interval=100)
    with pytest.raises(SystemExit) as e:
        _window(tmp).fit(_TinyDataset(n=6), epochs=1)
    assert e.value.code == 3


def _uint8_device_cache_equals_f32(tmp):
    rng = np.random.default_rng(0)
    img_dir = tmp / "imgs"
    img_dir.mkdir()
    for i in range(2):
        arr = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"im{i}.png")
    pairs = [{"lr": (16, 16), "hr": (32, 32)}]
    losses = []
    for uint8 in (False, True):
        ds = HighresImageDataset(str(img_dir), scale_pairs=pairs, uint8=uint8)
        tr = Trainer("FastTransformer", checkpoint_dir=str(tmp / f"c{uint8}"),
                     dtype=torch.float32, device="cpu", **SMALL)
        losses.append(tr.fit(ds, epochs=1, batch_size=2, resume=False,
                             device_cache=uint8)[0])
    assert abs(losses[0] - losses[1]) < 1e-6, losses


SEMANTICS = {"loss_falls": _loss_falls,
             "bucketed_equals_per_sample": _bucketed_equals_per_sample,
             "resume": _resume,
             "refused_resume_exits_3": _refused_resume_exits_3,
             "uint8_device_cache_equals_f32": _uint8_device_cache_equals_f32}


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_jax_training_semantics(tmp_path, case):
    SEMANTICS[case](tmp_path)


# ------------------------------------------------------------------ dropout
def _pattern(shape, keep: float) -> np.ndarray:
    """A fixed keep mask of ``shape`` (a hash of the element index)."""
    n = int(np.prod(shape))
    h = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)
         + np.uint64(12345)) % np.uint64(2 ** 32)
    return (h.astype(np.float64) / 2.0 ** 32 < keep).reshape(shape)


MODEL_CASES = {
    "FastTransformer": (SMALL, (16, 32), (32, 64)),
    "WindowTransformer": (SMALL, (32, 32), (64, 64)),
    "ResidualTransformer": (RESID_SMALL, (32, 64), (64, 128)),
}


@pytest.fixture(scope="module")
def jax_models():
    """Each model's JAX module at narrow width, with seeded parameters
    (``weights.seeded_params``: non-zero biases, so that a misplaced site
    shows)."""
    out = {}
    for name, (cfg, _, _) in MODEL_CASES.items():
        m = jax_get_model(name, dtype=jnp.float32, dropout=0.1, **cfg)
        out[name] = (m, seeded_params(get_model(name, device="cpu", **cfg),
                                      0))
    return out


def _port(name, params, rate):
    cfg = MODEL_CASES[name][0]
    model = get_model(name, device="cpu", dropout=rate, **cfg)
    return params_from_jax(model, params)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_dropout_sites_match_jax(jax_models, monkeypatch, name):
    """The same keep masks on both sides (``_pattern`` in place of
    ``jax.random.bernoulli`` and of the port's draw): at rate 0.1 the
    train-mode forward equals JAX's ``deterministic=False`` one, so the
    port drops where JAX drops and nowhere else. The port's sites: window
    attention's probabilities and output and the MLP's output in each
    window block; global attention's probabilities and the MLP's output in
    each global block."""
    m, params = jax_models[name]
    _, lr_hw, hr_hw = MODEL_CASES[name]
    x = np.random.default_rng(2).random((2, *lr_hw, 3), np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None, mode=None:
                        jnp.asarray(_pattern(tuple(shape), float(p))))
    want = jax_apply(m, params, x, hr_hw, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1)})
    sites = []

    def keep_mask(self, t):
        sites.append(tuple(t.shape))
        return torch.from_numpy(_pattern(tuple(t.shape), 1.0 - self.rate))

    monkeypatch.setattr(TC.Dropout, "keep_mask", keep_mask)
    model = _port(name, params, 0.1).train()
    got = model(torch.from_numpy(x), res_out=hr_hw, require_ratio=False,
                generator=torch.Generator()).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)
    blocks = 2
    per_block = 3 if name != "ResidualTransformer" else 2
    assert len(sites) == blocks * per_block, sites
    model.eval()
    eval_out = model(torch.from_numpy(x), res_out=hr_hw,
                     require_ratio=False).numpy()
    assert np.abs(eval_out - got).max() > 1e-3  # the masks did drop


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_dropout_rate_0_train_equals_eval_equals_jax(jax_models, name):
    m, params = jax_models[name]
    _, lr_hw, hr_hw = MODEL_CASES[name]
    x = np.random.default_rng(3).random((1, *lr_hw, 3), np.float32)
    m0 = m.clone(dropout=0.0)
    want = jax_apply(m0, params, x, hr_hw, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1)})
    model = _port(name, params, 0.0)
    ev = model(torch.from_numpy(x), res_out=hr_hw, require_ratio=False)
    model.train()
    tr = model(torch.from_numpy(x), res_out=hr_hw, require_ratio=False)
    assert tr.requires_grad is False  # serving parameters need no grad
    np.testing.assert_array_equal(tr.detach().numpy(), ev.numpy())
    np.testing.assert_allclose(ev.numpy(), want, **F32)


def test_dropout_reproducible_from_a_seeded_generator(jax_models):
    m, params = jax_models["FastTransformer"]
    model = _port("FastTransformer", params, 0.1).train()
    x = torch.from_numpy(np.random.default_rng(4).random((1, 16, 32, 3),
                                                         np.float32))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return model(x, res_out=(32, 64), generator=g).detach()

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    with pytest.raises(ValueError, match="Generator"):
        model(x, res_out=(32, 64))
    drop = TC.Dropout(0.1, torch.Generator().manual_seed(0))
    y = drop(torch.ones(200_000))
    zeros = float((y == 0).float().mean())
    assert abs(zeros - 0.1) < 4 * (0.1 * 0.9 / 200_000) ** 0.5
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, 1 / 0.9))


# ------------------------------------------------------------ initialisers
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_init_matches_jax_init(name):
    """Same paths and shapes as JAX's ``model.init`` (traced with
    ``jax.eval_shape``); biases 0, LayerNorm scales 1; every other leaf's
    mean and std within five standard errors of its JAX initialiser's (the
    truncated normal's std is sigma x TRUNCATED_UNIT_STD), and no truncated
    value beyond 2 sigma. The same holds for JAX's own values where this
    module computes them (FastTransformer, WindowTransformer)."""
    cfg, lr_hw, hr_hw = MODEL_CASES[name]
    model = get_model(name, device="cpu", **cfg)
    got = flatten(init_params(model, 0))
    jm = jax_get_model(name, dtype=jnp.float32, **cfg)
    x = jnp.zeros((1, *lr_hw, 3), jnp.float32)
    shapes = flatten(jax.eval_shape(
        lambda key: jm.init(key, x, res_out=hr_hw,
                            require_ratio=False)["params"],
        jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    jax_values = flatten(jax_init(name)) if name in MODELS else {}
    for path in shapes:
        g = got[path].numpy()
        leaf = path.rsplit("/", 1)[-1]
        w = jax_values.get(path, g)
        if leaf.endswith("bias"):
            assert not g.any() and not w.any(), path
            continue
        if leaf == "scale":
            assert (g == 1).all() and (w == 1).all(), path
            continue
        if leaf == "pos_embed":
            sigma, bound = 1.0, None
        elif leaf == "bias_table":
            sigma, bound = 0.02 * TRUNCATED_UNIT_STD, 0.04
        else:
            s = (1.0 / np.prod(g.shape[:-1])) ** 0.5 / TRUNCATED_UNIT_STD
            sigma, bound = s * TRUNCATED_UNIT_STD, 2 * s
        n = g.size
        for v in (g, jax_values.get(path, g)):
            assert abs(v.mean()) <= 5 * sigma / n ** 0.5, path
            assert abs(v.std() / sigma - 1) <= 5 / (2 * n) ** 0.5, path
            if bound is not None:
                assert np.abs(v).max() <= bound * (1 + 1e-6), path
    assert not np.array_equal(got[sorted(got)[-1]].numpy(),
                              flatten(init_params(model, 1))[sorted(got)[-1]]
                              .numpy())


# ------------------------------------------------------ serve, train, serve
def test_serve_train_serve_in_one_process():
    """A model served on its serving forward (the stream kernels' plain
    versions on the CPU, the fused trunk's stacked weights and the composed
    tails cached under inference mode), trained one step, and served again:
    no inference-tensor error, and the second serve equals a fresh model
    loaded with the new parameters."""
    flags = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2")
    tr = Trainer("FastTransformer", device="cpu", dtype=torch.float32,
                 **flags, **SMALL)
    tr.init_params()
    x = torch.from_numpy(np.random.default_rng(5).random((1, 16, 32, 3),
                                                         np.float32))
    tr.model.eval()
    first = tr.model(x, upscale_factor=2)
    assert tr.model._tails and tr.model._trunk  # derived weights cached
    tr.model.train()
    tr.train_step(_batch(1), torch.Generator().manual_seed(0))
    tr.model.eval()
    second = tr.model(x, upscale_factor=2)
    fresh = get_model("FastTransformer", device="cpu", **flags, **SMALL)
    params_from_jax(fresh, tr.params())
    np.testing.assert_array_equal(second.numpy(),
                                  fresh(x, upscale_factor=2).numpy())
    assert not torch.equal(first, second)


# ------------------------------------------------------ the card's fixture
def test_full_width_step_matches_the_fixture():
    """chip_smoke.py's ``train`` check on the CPU: the full-width f32 step
    from the epoch-100 weights against JAX's checksums
    (train_step_FastTransformer.npz), within chip_smoke's ``TRAIN_TOL``."""
    import chip_smoke

    step = chip_smoke.train_step_vs_jax("cpu")
    assert step["kernel_launches"] == 0
    for kind, err in step["errors"].items():
        assert err <= chip_smoke.TRAIN_TOL[kind], (kind, step["errors"])


# ---------------------------------------------------------------------- CLI
def test_train_cli(tmp_path, capsys):
    """``python -m transformerupscaler_torch.train`` on the CPU: trains
    from a directory of PNGs into ``model_epoch_1.npz``, refuses to go on
    past it with exit code 3; the stale default model raises KeyError with
    the model list; ``--mesh 2 --device cpu`` trains on two replicas of
    the CPU."""
    from transformerupscaler_torch import train as cli

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (120, 100, 3), np.uint8)).save(img_dir / "a.png")
    ck = tmp_path / "ck"
    args = ["--model", "WindowTransformer", "--data_dir", str(img_dir),
            "--pairs", "small", "--epochs", "1", "--batch_size", "4",
            "--dtype", "f32", "--device", "cpu", "--checkpoint_dir", str(ck)]
    cli.main(cli.parser().parse_args(args))
    out = capsys.readouterr().out
    assert "Training on device: cpu" in out and "Training complete!" in out
    assert get_latest_checkpoint(str(ck))[1] == 1
    with pytest.raises(SystemExit) as e:
        cli.main(cli.parser().parse_args(args))
    assert e.value.code == 3
    with pytest.raises(KeyError, match="FastTransformer"):
        cli.main(cli.parser().parse_args(["--data_dir", str(img_dir),
                                          "--device", "cpu"]))
    # Two replicas on a mesh of the CPU, one more epoch from the
    # checkpoint; a mesh argument that is not a Mesh raises TypeError.
    cli.main(cli.parser().parse_args(
        [*args[:7], "2", *args[8:], "--mesh", "2"]))
    out = capsys.readouterr().out
    assert "Device mesh: {'data': 2, 'model': 1}" in out
    assert "Training complete!" in out
    assert get_latest_checkpoint(str(ck))[1] == 2
    with pytest.raises(TypeError, match="Mesh"):
        Trainer("WindowTransformer", device="cpu", mesh=object())


# ------------------------------------------------------------------ fixture
def write_fixture() -> None:
    """The card's f32 step at full width: JAX's Trainer on FastTransformer
    (dim 192, 6 blocks, 12 heads), dropout 0, from the epoch-100 checkpoint
    (the card reads its numpy copy), on two 32x64 -> 64x128 samples and one
    32x64 -> 48x96 (squashed). Checksums, each a float64: the loss; per
    leaf, the gradient's sum of squares and its dot with a probe (standard
    normal, ``np.random.default_rng(PROBE_SEED)`` drawn leaf by leaf in
    sorted path order), and the same of the parameters after the Adam step
    and of the step itself (after - before)."""
    from transformerupscaler_tpu.checkpoint import (
        default_checkpoint_dir,
        get_latest_checkpoint as jax_latest,
        load_checkpoint as jax_load,
    )

    jt = JaxTrainer("FastTransformer", dtype=jnp.float32, dropout=0.0,
                    checkpoint_dir=os.path.join(ROOT, "unused"))
    path, epoch = jax_latest(default_checkpoint_dir("FastTransformer", ROOT))
    jt.params = jax.tree.map(jnp.asarray, jax_load(path)["params"])
    jt.opt_state = jt.optimizer.init(jt.params)
    samples = _batch(7, (32, 64), ((64, 128), (64, 128), (48, 96)))
    before = flatten(_np(jt.params))
    grads = jax_grads(jt, samples)
    loss = jt.train_step(samples, jax.random.PRNGKey(0))
    after = flatten(_np(jt.params))
    probe_rng = np.random.default_rng(PROBE_SEED)
    out = {"loss": np.float64(loss), "epoch": np.int64(epoch),
           "probe_seed": np.int64(PROBE_SEED),
           "paths": np.array(sorted(before))}
    for i, lr_hr in enumerate(samples):
        out[f"lr_{i}"], out[f"hr_{i}"] = lr_hr
    for name in ("grad_sumsq", "grad_dot", "param_sumsq", "param_dot",
                 "step_sumsq", "step_dot"):
        out[name] = np.zeros(len(before))
    for i, path in enumerate(sorted(before)):
        probe = probe_rng.standard_normal(before[path].shape)
        step = after[path].astype(np.float64) - before[path]
        for kind, v in (("grad", grads[path]), ("param", after[path]),
                        ("step", step)):
            v = np.asarray(v, np.float64)
            out[f"{kind}_sumsq"][i] = (v * v).sum()
            out[f"{kind}_dot"][i] = (v * probe).sum()
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE}: loss {loss}, {len(before)} leaves")


PROBE_SEED = 19

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(write_fixture())
