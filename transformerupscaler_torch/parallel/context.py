"""Head sharding (JAX counterpart: transformerupscaler_tpu/parallel/
context.py).

In JAX, ``activation_sharding(mesh)`` makes the attention ops constrain
their per-head tensors to the ``model`` mesh axis, a layout annotation
that GSPMD turns into a split of the heads over the chips; the math is
unchanged. Here the split is made by hand: while a context with
``model`` > 1 is active, ``maybe_shard_heads`` cuts the heads axis (-3) of
q, k and v (and of window attention's relative bias) into ``model``
contiguous groups and copies group j to ``mesh.devices[row, j]``, where
``row`` is the data row of the replica that calls. The attention ops then
compute each group's scores, softmax and context on its device and
``gather_heads`` copies the contexts back to the caller's device and
concatenates them. The copies are ``Tensor.to``, so autograd crosses them.
Off a context, or at ``model`` == 1, nothing is cut and no copy is made.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


class HeadSharding:
    """An active context: the mesh, its head axis, the caller's data row,
    and ``placements``, the (group, device) of every group cut."""

    def __init__(self, mesh, head_axis: str, row: int):
        if head_axis not in mesh.axis_names:
            raise ValueError(f"{head_axis!r} is not an axis of {mesh}")
        self.mesh, self.head_axis, self.row = mesh, head_axis, row
        self.groups = mesh.shape[head_axis]
        self.placements: list = []

    def devices(self) -> list:
        return list(self.mesh.devices[self.row])


@contextlib.contextmanager
def activation_sharding(mesh, head_axis: str = "model", row: int = 0):
    """Cut the attention heads over ``mesh``'s ``head_axis`` inside the
    block, onto the devices of data row ``row``. Yields the
    ``HeadSharding``."""
    prev = getattr(_state, "cfg", None)
    _state.cfg = HeadSharding(mesh, head_axis, row)
    try:
        yield _state.cfg
    finally:
        _state.cfg = prev


def maybe_shard_heads(x: torch.Tensor):
    """x: (..., heads, N, d). Off a context (or with one group): x itself.
    Under ``activation_sharding``: a list of the head groups, group j on
    the j-th device of the caller's data row."""
    cfg = getattr(_state, "cfg", None)
    if cfg is None or cfg.groups == 1:
        return x
    heads = x.shape[-3]
    if heads % cfg.groups:
        raise ValueError(f"{heads} heads do not split into {cfg.groups} "
                         f"groups")
    parts = []
    for j, (part, dev) in enumerate(zip(x.chunk(cfg.groups, dim=-3),
                                        cfg.devices())):
        parts.append(part.to(dev))
        cfg.placements.append((j, dev))
    return parts


def gather_heads(parts: list, device) -> torch.Tensor:
    """The head groups' results back on ``device``, concatenated along the
    heads axis (-3)."""
    return torch.cat([p.to(device) for p in parts], dim=-3)
