"""The port's UpscalerEngine against the JAX package's
(transformerupscaler_tpu/infer_lib.py): the weights it finds and loads,
``param_count``, ``quantize``, ``device_out``, ``warmup`` and the fast-gate
warning, on the CPU; and the port's bench configurations against bench.py's.
The engine's CUDA graphs are held on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import importlib.util
import os
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from transformerupscaler_torch import bench
from transformerupscaler_torch.checkpoint import param_count
from transformerupscaler_torch.infer_lib import UpscalerEngine, _failing_op
from transformerupscaler_torch.models.common import resolve_geometry
from transformerupscaler_torch.ops.quant import quantize_linear_params
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import seeded_params
from transformerupscaler_tpu import registry as jax_registry
from transformerupscaler_tpu.checkpoint import load_checkpoint as jax_load
from transformerupscaler_tpu.infer_lib import UpscalerEngine as JaxEngine
from transformerupscaler_tpu.ops.quant import (
    quantize_linear_params as jax_quantize,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULTS = {"FastTransformer": 100, "WindowTransformer": 40,
            "ResidualTransformer": 17}
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
TOL = dict(atol=5e-5, rtol=1e-4)  # tests/test_parity.py:69
SMALL = dict(transformer_dim=32, num_window_blocks=1, num_heads=2)


def demo_input(name) -> np.ndarray:
    img = Image.open(os.path.join(ROOT, "models", name, "demo", "input.png"))
    return np.asarray(img.convert("RGB"), np.uint8)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_engine_loads_what_jax_loads(name):
    """Given no params, both engines load the same checkpoint: the same
    epoch, path and parameter count."""
    port = UpscalerEngine(name, device="cpu", root=ROOT)
    jax_engine = JaxEngine(name, root=ROOT)
    assert port.epoch == jax_engine.epoch == DEFAULTS[name]
    assert port.checkpoint_path == jax_engine.checkpoint_path
    assert port.param_count() == jax_engine.param_count()


def test_engine_falls_back_to_seeded_weights(tmp_path):
    engine = UpscalerEngine(device="cpu", root=str(tmp_path), seed=3, **SMALL)
    assert engine.epoch == 0 and engine.checkpoint_path is None
    model = get_model("FastTransformer", device="cpu", **SMALL)
    assert engine.param_count() == param_count(seeded_params(model, 3))
    # The trained tree does not fit a narrow model: that raises, as in JAX.
    with pytest.raises(ValueError, match="does not fit"):
        UpscalerEngine(device="cpu", root=ROOT, **SMALL)


@pytest.mark.parametrize("name", ["FastTransformer", "WindowTransformer"])
def test_port_on_cpu_matches_trained_fixture(name):
    """The check chip_smoke.py makes on the card: the default engine on the
    trained weights against the JAX default engine's output."""
    with np.load(os.path.join(FIXTURES, f"trained_{name}.npz")) as f:
        x, y = f["x"], f["y"]
        y0, x0, h, w = (int(v) for v in f["crop"])
        scale = int(f["scale"])
    engine = UpscalerEngine(name, device="cpu", root=ROOT)
    got = engine.upscale(x[y0:y0 + h, x0:x0 + w], upscale_factor=scale)
    assert got.shape == y.shape
    np.testing.assert_allclose(got, y, **TOL)


@pytest.fixture(scope="module")
def jax_trees():
    return {name: jax_load(os.path.join(ROOT, "models", name, "checkpoints",
                                        f"model_epoch_{epoch}"), name)
            for name, epoch in DEFAULTS.items()}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_quantize_linear_params_matches_jax(jax_trees, name):
    tree = {"params": jax_trees[name]["params"]}
    want, got = flat(jax_quantize(tree)), flat(quantize_linear_params(tree))
    assert sorted(got) == sorted(want)
    changed = 0
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        changed += not np.array_equal(v, flat(tree)[k])
    assert changed >= 4  # the projections and MLPs, not the convs


@pytest.mark.parametrize("name", ["FastTransformer", "WindowTransformer"])
def test_quantize_engine_matches_jax(name):
    x = demo_input(name)[74:106, 128:192]  # the central 32x64
    port = UpscalerEngine(name, device="cpu", root=ROOT, quantize=True)
    jax_engine = JaxEngine(name, root=ROOT, quantize=True)
    got = port.upscale(x, upscale_factor=2)
    np.testing.assert_allclose(got, jax_engine.upscale(x, upscale_factor=2),
                               **TOL)
    plain = UpscalerEngine(name, device="cpu", root=ROOT)
    assert np.abs(plain.upscale(x, upscale_factor=2) - got).max() > 1e-4


def test_device_out_and_warmup(tmp_path):
    engine = UpscalerEngine(device="cpu", root=str(tmp_path), **SMALL)
    img = np.random.default_rng(0).integers(0, 256, (16, 32, 3), np.uint8)
    out = engine.upscale(img, res_out=(24, 48), device_out=True)
    assert isinstance(out, torch.Tensor) and out.device == engine.device
    assert out.dtype == torch.float32 and out.shape == (24, 48, 3)
    np.testing.assert_array_equal(out.numpy(),
                                  engine.upscale(img, res_out=(24, 48)))
    seconds = engine.warmup((16, 32), upscale_factor=2, batch=2)
    assert isinstance(seconds, float) and seconds > 0


def test_capture_failure_names_the_op():
    """A failed capture ends in the graph's own error, raised while the
    op's error was handled: the message names the op's line in the port."""
    try:
        try:
            resolve_geometry((16, 32), None, None)
        except TypeError:
            raise RuntimeError("capture invalidated")  # noqa: B904
    except RuntimeError as e:
        assert "models/common.py:" in _failing_op(e)
        assert "res_out[0] / h" in _failing_op(e)
    assert _failing_op(ValueError("x")) == "an op outside the port's code"


# (NHWC shape, res_out, upscale_factor): served, and each way to miss the
# gate (scale, h % 8, w % 16).
GEOMETRIES = [((1, 16, 32, 3), None, 2), ((1, 16, 32, 3), (24, 48), None),
              ((1, 12, 32, 3), None, 2), ((1, 16, 24, 3), None, 3),
              ((1, 16, 32, 3), None, 5), ((1, 16, 32, 3), (80, 160), None),
              ((2, 8, 16, 3), None, 6)]


def _warnings(engine, geometries) -> list[str]:
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for g in geometries:
            engine._warn_if_fast_gate_misses(*g)
    return [str(w.message) for w in seen]


@pytest.mark.parametrize("flags", [dict(packed_serve=True),
                                   dict(int8_serve=True), {}])
def test_fast_gate_warning_fires_where_jax_does(tmp_path, flags):
    def port():
        return UpscalerEngine(device="cpu", root=str(tmp_path),
                              compose_tails=True, pallas_serve=True,
                              **flags, **SMALL)

    def jax():
        return JaxEngine("FastTransformer", params={}, **flags)

    fired = []
    for g in GEOMETRIES:
        got, want = _warnings(port(), [g]), _warnings(jax(), [g])
        assert got == want, g
        fired += got
    assert len(fired) == (4 if flags else 0)
    assert _warnings(port(), GEOMETRIES) == _warnings(jax(), GEOMETRIES)
    assert len(_warnings(port(), GEOMETRIES)) == (1 if flags else 0)


def _bench_py_flags(config, monkeypatch) -> dict:
    """The flags of the model the repo's bench.py serves for ``config``:
    its main() run with the JAX model and the timing chain swapped for
    stand-ins that record what it builds."""
    from tools import probe_lib

    built = []

    class Stub:
        def init(self, *args, **kwargs):
            return {}

        def apply(self, params, x, **kwargs):
            scales = {f"int8_scale_{n}": (jnp.ones(64),)
                      for n in ("feat1", "feat", "dec")}
            return x, {"intermediates": scales}

    def get_stub(name, **kwargs):
        built.append(kwargs)
        return Stub()

    def chain(fn):
        return lambda params, x, m: time.sleep(1e-4 * m)

    monkeypatch.setattr(jax_registry, "get_model", get_stub)
    monkeypatch.setattr(probe_lib, "chained_dyn", chain)
    monkeypatch.setenv("TUX_BENCH_CONFIG", config)
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()
    served = dict(built[-1])
    for key in ("dtype", "int8_scales"):
        served.pop(key, None)
    if not served.get("serve_quality", True):
        del served["serve_quality"]
    return served


@pytest.mark.parametrize("config", bench.CONFIGS)
def test_bench_configs_build_bench_py_flags(config, monkeypatch):
    """Each TUX_BENCH_CONFIG builds bench.py's flags, but int8_residual and
    int8_full with pallas_serve=True: bench.py serves them on JAX's all-XLA
    packed path, which the port does not have."""
    want = _bench_py_flags(config, monkeypatch)
    flags, calibrate = bench.bench_flags(config)
    if config.removesuffix("_trunk") in ("int8_residual", "int8_full"):
        assert want["pallas_serve"] is False
        want["pallas_serve"] = True
    assert flags == want
    assert calibrate == config.startswith("int8")
    get_model("FastTransformer", device="cpu", dtype=torch.bfloat16, **flags,
              **SMALL)


def test_bench_quality_and_unknown_configs_raise():
    with pytest.raises(NotImplementedError, match="serve_quality"):
        bench.bench_flags("quality")
    with pytest.raises(ValueError, match="TUX_BENCH_CONFIG"):
        bench.bench_flags("fp8")
