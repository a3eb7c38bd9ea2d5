"""The port's metrics (transformerupscaler_torch/metrics.py) against the JAX
package's (transformerupscaler_tpu/metrics.py) on random arrays: both are
float64 numpy and scipy with the same operations, so within 1e-12."""

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import metrics
from transformerupscaler_tpu import metrics as jax_metrics


@pytest.mark.parametrize("shape", [(17, 23, 3), (64, 48, 3), (9, 9, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_metrics_match_jax(shape, dtype):
    rng = np.random.default_rng(shape[0])
    a = rng.random(shape).astype(dtype)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(dtype)
    for name, kw, x, y in (
            ("psnr", dict(data_range=1.0), a, b),
            ("ssim", dict(data_range=1.0, channel_axis=-1), a, b),
            ("ssim", dict(data_range=2.0, channel_axis=None), a[..., 0],
             b[..., 0]),
            ("mse", {}, a, b)):
        got = getattr(metrics, name)(x, y, **kw)
        want = getattr(jax_metrics, name)(x, y, **kw)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (name, kw)


def test_identical_images():
    a = np.random.default_rng(0).random((16, 16, 3))
    assert metrics.psnr(a, a) == float("inf") == jax_metrics.psnr(a, a)
    assert metrics.ssim(a, a) == pytest.approx(1.0, abs=1e-12)
    assert metrics.mse(a, a) == 0.0
