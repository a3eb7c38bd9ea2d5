"""Device meshes (JAX counterpart: transformerupscaler_tpu/parallel/mesh.py).

A ``Mesh`` is a grid of torch devices with a ``data`` axis (replicas of
the model, each on its share of the batch) and a ``model`` axis (the
attention heads cut into groups, ``parallel.context``). One Python process
drives every device of it, as JAX's single controller drives its chips:
there is no ``torch.distributed``, no process group and no NCCL; work is
queued on each device in turn and tensors cross between devices by copies.

The devices may repeat. ``make_mesh(2, devices=["cpu", "cpu"])`` or
``devices=[cuda:0, cuda:0]`` is a mesh of two replicas on one device: the
only way to run a split of two or more on the CPU or on one card, with the
same arithmetic and placement logic as on distinct cards (but no overlap
between them).
"""

from __future__ import annotations

import numpy as np
import torch

AXES = ("data", "model")


class Mesh:
    """``devices``: an object array of ``torch.device`` of shape
    (data, model); ``shape``: {"data": rows, "model": columns}."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-d grid of devices, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    """A mesh of shape (n_devices // tp, tp) with axes ("data", "model").

    ``devices`` (torch devices or their names, repeats allowed) defaults
    to every visible CUDA device; with none visible it raises, as the
    port's entry points do. ``n_devices`` defaults to all of ``devices``;
    more than there are, or a count that ``tp`` does not divide, raises
    ValueError as JAX's does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; make_mesh takes the visible GPUs "
                "unless the caller passes devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    if n_devices % tp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by tp={tp}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(n_devices // tp, tp))


def cli_mesh(n: int, tp: int = 1, device=None) -> Mesh:
    """The mesh of a command line's ``--mesh n --tp tp`` (n = -1: every
    device): over the visible cards, or under ``--device cpu`` over the CPU
    repeated n times (once for -1)."""
    if device is not None and torch.device(device).type == "cpu":
        count = n if n > 0 else 1
        return make_mesh(count, tp, devices=["cpu"] * count)
    return make_mesh(n if n > 0 else None, tp)
