"""Checkpoints, found as the JAX package finds them (counterpart of
transformerupscaler_tpu/checkpoint.py): the highest ``model_epoch_{n}``
under ``models/<Model>/checkpoints/`` wins, an Orbax directory or a legacy
``model_epoch_{n}.pth``.

The committed Orbax checkpoints store their arrays zstd-compressed, and the
card's host can read neither zstd nor Orbax. So each default checkpoint has
a numpy copy beside the port, ``checkpoints/<Model>/model_epoch_<n>.npz``:
its parameters as float32 arrays keyed by JAX path
(``blocks_0/attn/qkv_kernel``) and the fingerprint of the Orbax directory
it was read from. Loading an Orbax directory reads its copy, after checking
the fingerprint against the directory as it is now and the copy's leaves
against the directory's ``_METADATA``. A missing or stale copy raises
``StaleCopyError``, never ``FileNotFoundError``: the engine falls back to
seeded weights only where there is no checkpoint at all. The copies are
written from the JAX package's own loader by ``GENERATOR``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path

import numpy as np

from transformerupscaler_torch.torch_convert import load_pth

_EPOCH_RE = re.compile(r"model_epoch_(\d+)(?:\.pth)?$")
COPIES = Path(__file__).resolve().parent / "checkpoints"
GENERATOR = "PYTHONPATH=. python tests/test_torch_checkpoint.py"
FINGERPRINT = "_fingerprint"  # the copy's key for its source's fingerprint


class StaleCopyError(RuntimeError):
    """An Orbax checkpoint whose numpy copy is missing or no longer matches
    it."""


def default_checkpoint_dir(model_name: str, root: str = ".") -> str:
    return os.path.join(root, "models", model_name, "checkpoints")


def get_latest_checkpoint(checkpoint_dir: str) -> tuple[str, int]:
    """(path, epoch) of the highest-epoch checkpoint in ``checkpoint_dir``:
    an Orbax directory ``model_epoch_{n}`` or a file ``model_epoch_{n}.pth``.
    Raises FileNotFoundError when there is none."""
    entries = []
    for f in os.listdir(checkpoint_dir):
        m = _EPOCH_RE.match(f)
        if m:
            entries.append((int(m.group(1)), f))
    if not entries:
        raise FileNotFoundError(
            f"No checkpoint files found in directory: {checkpoint_dir}")
    epoch, name = max(entries)
    return os.path.join(checkpoint_dir, name), epoch


def fingerprint(orbax_dir: str) -> str:
    """sha256 over the files of an Orbax directory in sorted relative-path
    order: each path ('/'-separated), a NUL, its length in 8 bytes, then its
    bytes."""
    root = Path(orbax_dir)
    files = sorted(p.relative_to(root).as_posix()
                   for p in root.rglob("*") if p.is_file())
    h = hashlib.sha256()
    for rel in files:
        data = (root / rel).read_bytes()
        h.update(rel.encode() + b"\0" + len(data).to_bytes(8, "little"))
        h.update(data)
    return h.hexdigest()


def copy_path(orbax_dir: str) -> Path:
    """Where the numpy copy of ``models/<Model>/<dir>/model_epoch_<n>``
    lies: ``checkpoints/<Model>/model_epoch_<n>.npz`` beside this module."""
    src = Path(orbax_dir).resolve()
    return COPIES / src.parent.parent.name / f"{src.name}.npz"


def metadata_shapes(orbax_dir: str) -> dict[str, tuple[int, ...]]:
    """{JAX path: shape} of every parameter leaf the directory's
    ``_METADATA`` lists (``tree_metadata``, ``write_shape``)."""
    with open(os.path.join(orbax_dir, "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    shapes = {}
    for leaf in tree.values():
        keys = [k["key"] for k in leaf["key_metadata"]]
        if keys[0] == "params":
            shapes["/".join(keys[1:])] = tuple(
                leaf["value_metadata"]["write_shape"])
    return shapes


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _read_npz(path) -> tuple[dict, str | None]:
    """(flat {JAX path: float32 array}, the stored fingerprint or None)."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files if k != FINGERPRINT}
        stamp = str(f[FINGERPRINT]) if FINGERPRINT in f.files else None
    return flat, stamp


def _read_copy(orbax_dir: str) -> dict:
    copy = copy_path(orbax_dir)
    if not copy.is_file():
        raise StaleCopyError(
            f"{orbax_dir} has no numpy copy ({copy}); the card cannot read "
            f"Orbax: write the copy with `{GENERATOR}`")
    flat, stamp = _read_npz(copy)
    if stamp != fingerprint(orbax_dir):
        raise StaleCopyError(
            f"{copy} is stale: its fingerprint does not match {orbax_dir}; "
            f"rewrite it with `{GENERATOR}`")
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if got != metadata_shapes(orbax_dir):
        raise StaleCopyError(
            f"{copy} does not hold the leaves and shapes of {orbax_dir}'s "
            f"_METADATA; rewrite it with `{GENERATOR}`")
    return flat


def load_checkpoint(path: str, model_name: str | None = None) -> dict:
    """{"params": tree} of a checkpoint, the tree as ``weights.params_from_jax``
    takes it: an Orbax directory (read from its numpy copy, checked), a
    legacy ``.pth`` (``model_name`` required) or a copy's ``.npz``."""
    path = str(path)
    if path.endswith(".pth"):
        if model_name is None:
            raise ValueError("model_name is required to convert a .pth "
                             "checkpoint")
        return load_pth(path, model_name)
    if path.endswith(".npz"):
        return {"params": _unflatten(_read_npz(path)[0])}
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if not os.path.isfile(os.path.join(path, "_METADATA")):
        raise ValueError(f"not an Orbax checkpoint (no _METADATA): {path}")
    return {"params": _unflatten(_read_copy(path))}


def load_latest_params(model_name: str, checkpoint_dir: str | None = None,
                       root: str = ".") -> dict | None:
    """``{"params": ...}`` from the latest checkpoint of ``model_name``, or
    None when there is no checkpoint."""
    ckpt_dir = checkpoint_dir or default_checkpoint_dir(model_name, root)
    try:
        path, _ = get_latest_checkpoint(ckpt_dir)
    except (FileNotFoundError, NotADirectoryError):
        return None
    return {"params": load_checkpoint(path, model_name)["params"]}


def param_count(tree: dict) -> int:
    """The number of parameters in a (nested) tree of arrays."""
    return sum(param_count(v) if isinstance(v, dict) else int(np.size(v))
               for v in tree.values())
