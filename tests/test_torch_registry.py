"""The port's library surface against the JAX package's, on the CPU:
``registry.register_model`` / ``ModelEntry``, the names
``transformerupscaler_torch`` and ``transformerupscaler_torch.ops`` export
(every name of JAX's ``__init__.py`` and ``ops/__init__.py``), and
``resize_antialias_bilinear`` against JAX's (tests/test_parity.py's
atol=5e-5, rtol=1e-4)."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import transformerupscaler_torch as tt
import transformerupscaler_torch.ops as tops
import transformerupscaler_tpu as tux
import transformerupscaler_tpu.ops as jops
from transformerupscaler_torch import registry
from transformerupscaler_torch.infer_lib import UpscalerEngine

ROOT = Path(__file__).resolve().parent.parent


def _exported(init: Path) -> set:
    """The public names a package's ``__init__.py`` binds."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("sub", ["", "ops"])
def test_port_exports_every_jax_name(sub):
    jax_init = ROOT / "transformerupscaler_tpu" / sub / "__init__.py"
    names = _exported(jax_init)
    assert len(names) >= (10 if sub else 4)
    port = tops if sub else tt
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing
    assert _exported(ROOT / "transformerupscaler_torch" / sub
                     / "__init__.py") >= names


def test_top_level_names_work_as_jax_ones():
    assert tt.list_models() == tux.list_models()
    assert tt.resolutions == tux.resolutions
    model = tt.get_model("BicubicInterpolation", device="cpu")
    assert isinstance(model, torch.nn.Module)
    assert tt.__version__ == tux.__version__


def test_import_builds_nothing_and_imports_no_jax():
    """``import transformerupscaler_torch`` (and its ops) in a fresh
    process: no JAX module, no kernel library loaded or built."""
    code = ("import sys, transformerupscaler_torch as t, "
            "transformerupscaler_torch.ops\n"
            "from transformerupscaler_torch.kernels import _build\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'transformerupscaler_tpu')) for m in sys.modules), 'jax'\n"
            "assert not _build._loaded, 'loaded'\n"
            "print(t.list_models())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FastTransformer" in out.stdout


class ToyUpscaler(torch.nn.Module):
    """A user model: nearest-neighbour x2, scaled by one parameter."""

    def __init__(self, gain: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.tensor(gain, dtype=dtype),
                                       requires_grad=False)

    def forward(self, x, res_out=None, upscale_factor=None,
                require_ratio=True):
        y = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return (y * self.gain).to(x.dtype)


@pytest.fixture
def toy():
    registry.register_model("ToyUpscaler", "test model")(ToyUpscaler)
    yield
    registry._REGISTRY.pop("ToyUpscaler")


def test_registered_model_resolves_as_a_builtin(toy):
    entry = registry._REGISTRY["ToyUpscaler"]
    assert entry == registry.ModelEntry("ToyUpscaler", ToyUpscaler,
                                        "test model")
    assert "ToyUpscaler" in tt.list_models()
    assert tt.list_models() == sorted(tt.list_models())
    # Fields it lacks (the serving flags) are dropped, its own kept, the
    # dtype given, the module placed on the device.
    model = tt.get_model("ToyUpscaler", device="cpu", dtype=torch.bfloat16,
                         gain=0.5, compose_tails=True, attn_impl="fused2")
    assert isinstance(model, ToyUpscaler) and model.gain.item() == 0.5
    assert model.gain.dtype == torch.bfloat16
    assert model.gain.device == torch.device("cpu")
    with pytest.raises(TypeError):
        tt.get_model("ToyUpscaler", device="cpu", no_such_field=1)
    engine = UpscalerEngine("ToyUpscaler", device="cpu",
                            params={"gain": np.float32(1.0)})
    out = engine.upscale(np.full((4, 6, 3), 51, np.uint8), upscale_factor=2)
    assert out.shape == (8, 12, 3)
    np.testing.assert_allclose(out, 51 / 255, rtol=1e-6)


def test_a_function_factory_takes_every_field(toy):
    @registry.register_model("ToyFactory")
    def make(**fields):
        return ToyUpscaler(fields.get("gain", 2.0), fields["dtype"])

    try:
        assert tt.get_model("ToyFactory", device="cpu",
                            compose_tails=True).gain.item() == 2.0
    finally:
        registry._REGISTRY.pop("ToyFactory")
    with pytest.raises(KeyError, match="ToyFactory"):
        tt.get_model("ToyFactory")


def test_resize_antialias_bilinear_matches_jax():
    R = importlib.import_module("transformerupscaler_torch.ops.resize")
    x = np.random.default_rng(0).random((2, 36, 52, 3), np.float32)
    for out in ((24, 40), (54, 78), (36, 20)):
        got = tops.resize_antialias_bilinear(torch.from_numpy(x), out)
        want = jops.resize_antialias_bilinear(jnp.asarray(x), out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4)
        assert torch.equal(got, R.resize(torch.from_numpy(x), out,
                                         "bilinear", antialias=True))
