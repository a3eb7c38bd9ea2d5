"""Batch-sharded inference: a batch of frames spread over a mesh's data
axis (JAX counterpart: transformerupscaler_tpu/parallel/batch_infer.py).

Each data row of the mesh holds one replica of the model on its first
device (``mesh.devices[i, 0]``), all with the same weights. A batch is
split into contiguous shards in batch order, as JAX's ``P("data")``
shards it, and every shard's forward is queued on its device before any
device is waited for: the forward path has no collective, and the outputs
stay on their devices, as JAX's batch-sharded result stays unfetched.
"""

from __future__ import annotations

import numpy as np
import torch

from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import init_params, params_from_jax


class ShardedUpscaler:
    """One model replica per data-axis device of ``mesh``, taking frames as
    floats in [0, 1] as the JAX upscaler does. ``params``: a
    JAX tree (or ``{"params": tree}``) for every replica; None draws
    ``weights.init_params`` with seed 0, as JAX's ``model.init`` with
    ``PRNGKey(0)``. ``model_kw``: the model's fields and route flags."""

    def __init__(self, model_name: str, mesh, params=None,
                 dtype=torch.bfloat16, **model_kw):
        self.model_name = model_name
        self.mesh = mesh
        self.devices = list(mesh.devices[:, 0])
        self.n_data = len(self.devices)
        self.dtype = dtype
        self.replicas = [get_model(model_name, device=d, dtype=dtype,
                                   **model_kw) for d in self.devices]
        if params is None:
            params = init_params(self.replicas[0], 0, self.devices[0])
        for model in self.replicas:
            params_from_jax(model, params)

    def upscale_batch(self, batch_nhwc: np.ndarray,
                      res_out: tuple[int, int]) -> list[torch.Tensor]:
        """Upscale an NHWC batch of frames, floats in [0, 1], to ``res_out``.
        The batch reaches each replica as JAX's ``jnp.asarray(batch,
        dtype)`` gives it: cast to the upscaler's dtype on the device, a
        uint8 batch not divided by 255 (it is copied across the bus as
        uint8). Returns the outputs shard by shard in batch order, each on
        its replica's device and in the model's dtype, the zero padding cut
        off (a shard of padding alone comes back with no rows); the work is
        queued, not waited for."""
        batch = np.asarray(batch_nhwc)
        b = batch.shape[0]
        pad = -b % self.n_data
        if pad:
            batch = np.concatenate(
                [batch, np.zeros((pad, *batch.shape[1:]), batch.dtype)])
        host = torch.from_numpy(np.ascontiguousarray(batch))
        per = (b + pad) // self.n_data
        outs = []
        for i, (dev, model) in enumerate(zip(self.devices, self.replicas)):
            rows = slice(i * per, (i + 1) * per)
            x = host[rows]
            if dev.type == "cuda":
                x = x.pin_memory()
            x = x.to(dev, non_blocking=True).to(self.dtype)
            y = model(x, res_out=tuple(res_out))
            outs.append(y[:max(0, min(rows.stop, b) - rows.start)])
        return outs
