"""Rules of the PyTorch port that hold without a card: it imports nothing of
JAX or of the JAX package, its entry points default to the card, and its
weight carrier refuses trees that do not fit."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch.device import resolve_device
from transformerupscaler_torch.infer_lib import UpscalerEngine
from transformerupscaler_torch import ab_test as ab_test_cli
from transformerupscaler_torch import inference as inference_cli
from transformerupscaler_torch import speed_test as speed_test_cli
from transformerupscaler_torch import stream as stream_cli
from transformerupscaler_torch import train as train_cli
from transformerupscaler_torch.parallel.batch_infer import ShardedUpscaler
from transformerupscaler_torch.parallel.mesh import make_mesh
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.stream_lib import StreamPipeline
from transformerupscaler_torch.train_lib import Trainer
from transformerupscaler_torch.weights import params_from_jax, seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(transformer_dim=32, num_window_blocks=1, num_heads=2)
# The model flags of the JAX command lines' ``--fast`` on the accelerator
# (inference.py:83-98, speed_test.py:35-48; stream.py:51-61 and
# app_overlay.py:101-114 pass a subset), ``--int8_trunk`` off.
FAST_FLAGS = dict(compose_tails=True, packed_serve=True, pallas_serve=True,
                  attn_impl="fused2", serve_quality=False, int8_serve=False,
                  int8_scope="full", int8_mlp=False, int8_trunk=False)


def test_port_imports_no_jax():
    """Importing every module of the port, in a fresh interpreter, loads no
    jax, flax, orbax, tensorstore, zstandard, PIL or transformerupscaler_tpu
    module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import transformerupscaler_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'orbax', 'tensorstore',\n"
        "              'zstandard', 'PIL', 'transformerupscaler_tpu'))\n"
        "for m in ('ops.patch', 'kernels.gmha', 'kernels.window_attn',\n"
        "          'models.bicubic', 'models.window_transformer',\n"
        "          'models.residual_transformer', 'checkpoint',\n"
        "          'torch_convert', 'bench', 'ops.quant', 'ops.gptq',\n"
        "          'native', 'stream_lib', 'capture', 'stream',\n"
        "          'overlay', 'app_overlay', 'png', 'data',\n"
        "          'data.bucketing', 'data.datasets', 'train_lib',\n"
        "          'train', 'metrics', 'cli', 'inference', 'ab_test',\n"
        "          'speed_test', 'parallel', 'parallel.mesh',\n"
        "          'parallel.context', 'parallel.batch_infer',\n"
        "          'profiling'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 31  # the modules really loaded


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on a host without JAX: no import statement in it,
    at any depth, names jax, flax, orbax, tensorstore, zstandard, PIL or
    the JAX package."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "transformerupscaler_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "orbax", "tensorstore",
                        "zstandard", "PIL", "transformerupscaler_tpu"}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        UpscalerEngine(dtype=torch.bfloat16)
    for name in ("FastTransformer", "WindowTransformer",
                 "ResidualTransformer", "BicubicInterpolation"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(name)
        with pytest.raises(RuntimeError, match="CUDA"):
            UpscalerEngine(name)
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamPipeline(name, (16, 16), (32, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_cli.build_pipeline(stream_cli.parser().parse_args(["--fast"]))
    for name in ("FastTransformer", "WindowTransformer",
                 "ResidualTransformer"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(train_cli.parser().parse_args(
            ["--model", "FastTransformer", "--data_dir", "."]))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(train_cli.parser().parse_args(
            ["--model", "FastTransformer", "--data_dir", ".", "--mesh",
             "2"]))
    for cli, argv in ((inference_cli, ["--image_path", "x.png"]),
                      (ab_test_cli, ["--data_dir", ".", "--model_a",
                                     "BicubicInterpolation", "--model_b",
                                     "BicubicInterpolation"]),
                      (speed_test_cli, ["--data_dir", "."]),
                      (speed_test_cli, ["--data_dir", ".", "--mesh", "-1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(cli.parser().parse_args(argv))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedUpscaler("BicubicInterpolation", make_mesh(1))
    assert resolve_device("cpu") == torch.device("cpu")


def test_params_from_jax_rejects_missing_and_leftover_leaves():
    model = get_model("FastTransformer", device="cpu", **SMALL)
    tree = seeded_params(model, 0)
    del tree["conv1"]["bias"]
    tree["extra"] = {"kernel": np.zeros(3, np.float32)}
    tree["conv2"]["kernel"] = np.zeros((3, 3, 64, 32), np.float32)
    with pytest.raises(ValueError) as err:
        params_from_jax(model, tree)
    msg = str(err.value)
    assert "conv1/bias" in msg and "extra/kernel" in msg
    assert "conv2/kernel" in msg


def test_params_from_jax_round_trip():
    model = get_model("FastTransformer", device="cpu", **SMALL)
    tree = seeded_params(model, 5)
    params_from_jax(model, {"params": tree})
    np.testing.assert_array_equal(
        model.blocks[0].attn.qkv_kernel.numpy(),
        tree["blocks_0"]["attn"]["qkv_kernel"])
    np.testing.assert_array_equal(model.up1.s4_c1_bias.numpy(),
                                  tree["up1"]["s4_c1_bias"])


def test_other_routes_and_geometries_raise(tmp_path):
    """The fused trunks build for both window models and the ``--fast``
    flag set for all four, FastTransformer also with ``int8_serve``;
    int8_mlp and int8_weights raise. FastTransformer routes as JAX does:
    without the serve flags (``pallas_serve=False``, ``compose_tails=False``)
    it builds and serves the exact path, at x6 and outside the gate (12x32)
    too; with them x6 serves on the serving forward, as does
    ``packed_serve`` without ``pallas_serve`` (JAX's all-XLA packed path),
    and 12x32 falls through to the exact path."""
    for name, flags in (("FastTransformer", dict(attn_impl="fused")),
                        ("FastTransformer", FAST_FLAGS),
                        ("FastTransformer", {**FAST_FLAGS,
                                             "int8_trunk": True}),
                        ("FastTransformer", {**FAST_FLAGS,
                                             "int8_serve": True}),
                        ("WindowTransformer", dict(attn_impl="fused")),
                        ("WindowTransformer", FAST_FLAGS),
                        ("ResidualTransformer", FAST_FLAGS),
                        ("BicubicInterpolation", FAST_FLAGS)):
        m = get_model(name, device="cpu", **flags, **(
            SMALL if name == "FastTransformer" else {}))
        assert getattr(m, "attn_impl", flags["attn_impl"]) == \
            flags["attn_impl"]
        assert getattr(m, "int8_trunk", False) == flags.get("int8_trunk",
                                                            False)
    assert get_model("FastTransformer", device="cpu", int8_mlp=True,
                     **SMALL).blocks[0].int8_mlp
    assert get_model("FastTransformer", device="cpu", int8_serve=True,
                     int8_weights=(), **SMALL).int8_weights == ()
    x = torch.rand(1, 16, 32, 3, generator=torch.Generator().manual_seed(0))
    for flags in (dict(pallas_serve=False), dict(compose_tails=False)):
        m = get_model("FastTransformer", device="cpu", **flags, **SMALL)
        assert not m.pallas_serve and not m.compose_tails
        assert m(x, upscale_factor=2).shape == (1, 32, 64, 3)
    packed = get_model("FastTransformer", device="cpu", compose_tails=True,
                       packed_serve=True, **SMALL)
    assert packed.route(2).pallas is False
    assert packed(x, upscale_factor=2).shape == (1, 32, 64, 3)
    for route in (dict(attn_impl="fused2"), dict(split_tail=True),
                  dict(attn_impl="xla", split_tail=False, hi_lo_fin="wf"),
                  dict(attn_impl="fused2", conv1_stream=True)):
        get_model("FastTransformer", device="cpu", compose_tails=True,
                  pallas_serve=True, **route, **SMALL)
    with pytest.raises(KeyError):
        get_model("SwinIR", device="cpu")
    assert get_model("WindowTransformer", device="cpu",
                     int8_mlp=True).blocks[0].int8_mlp
    img = np.zeros((16, 32, 3), np.uint8)
    odd = np.zeros((12, 32, 3), np.uint8)
    # Seeded weights: the narrow model does not take the trained ones.
    engine = UpscalerEngine(device="cpu", root=str(tmp_path), **SMALL)
    assert engine.upscale(img, upscale_factor=6).shape == (96, 192, 3)
    assert engine.upscale(odd, upscale_factor=2).shape == (24, 64, 3)
    served = UpscalerEngine(device="cpu", root=str(tmp_path),
                            compose_tails=True, pallas_serve=True, **SMALL)
    assert served.model.route(6).direct_tails
    assert served.upscale(img, upscale_factor=6).shape == (96, 192, 3)
    assert served.upscale(odd, upscale_factor=2).shape == (24, 64, 3)


def _jax_engine_keywords() -> list[str]:
    """The keywords the JAX engine passes to ``get_model`` on every build
    (transformerupscaler_tpu/infer_lib.py:51-57), read from its source."""
    with open(os.path.join(ROOT, "transformerupscaler_tpu",
                           "infer_lib.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and ast.unparse(node.targets[0]) == "self._model_kwargs"):
            return [k.arg for k in node.value.keywords]
    raise AssertionError("no self._model_kwargs in the JAX engine")


# The JAX defaults of FastTransformer's serving fields (fast_transformer.py:
# 51, 102, 138, 163, 169): all served at other values too.
FIXED_DEFAULTS = dict(fix_ratio_bug=False, int8_weights=None,
                      quality_parts="tails", f32_tail=False, fold_pre=True)


def test_jax_engine_keyword_set_builds_every_model():
    """The JAX engine's keyword set, at the values of the ``--fast`` flags
    and the fields' defaults, builds all four models; so do the other
    FastTransformer fields at their defaults, which the other models drop
    as the JAX registry does."""
    keys = _jax_engine_keywords()
    assert {"f32_tail", "fold_pre", "split_tail", "hi_lo_fin"} <= set(keys)
    values = {**FAST_FLAGS, **FIXED_DEFAULTS, "split_tail": None,
              "hi_lo_fin": None}
    config = {k: values[k] for k in keys if k != "dtype"}
    assert set(config) == set(keys) - {"dtype"}
    for name in ("FastTransformer", "WindowTransformer",
                 "ResidualTransformer", "BicubicInterpolation"):
        small = SMALL if name == "FastTransformer" else {}
        get_model(name, device="cpu", dtype=torch.bfloat16, **config,
                  **small)
        m = get_model(name, device="cpu", **{**config, **FIXED_DEFAULTS},
                      conv1_stream=None, **small)
        assert getattr(m, "conv1_stream", None) is None


@pytest.mark.parametrize("field,value", [
    ("serve_quality", True), ("int8_weights", ()),
    ("quality_parts", "conv1,tails"), ("f32_tail", True),
    ("fold_pre", False)])
def test_fixed_fields_raise_not_implemented_off_their_default(field, value):
    """No field raises off its default any more: the serving fields
    (serve_quality, quality_parts, f32_tail, fold_pre) and the GPTQ entries
    (int8_weights, since the registry's FIXED_ROUTE went) build with the
    value."""
    flags = {**FAST_FLAGS, field: value}
    m = get_model("FastTransformer", device="cpu", **flags, **SMALL)
    assert getattr(m, field) == value
    # The other models drop the field, as the JAX registry does.
    get_model("WindowTransformer", device="cpu",
              **{**FAST_FLAGS, field: value})


def test_engine_upscale_contract(tmp_path):
    """uint8 HWC in, float32 HWC out in [0, 1]; NHWC keeps its batch."""
    engine = UpscalerEngine(device="cpu", dtype=torch.bfloat16,
                            root=str(tmp_path), **SMALL)
    img = np.random.default_rng(0).integers(0, 256, (16, 32, 3), np.uint8)
    out = engine.upscale(img, res_out=(24, 48))
    assert out.shape == (24, 48, 3) and out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 1.0
    batch = engine.upscale(np.stack([img, img]).astype(np.float32) / 255.0,
                           upscale_factor=2)
    assert batch.shape == (2, 32, 64, 3)
    np.testing.assert_array_equal(batch[0], batch[1])
