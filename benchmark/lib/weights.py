"""The configuration's weights: the committed numpy copy, read with numpy
and handed the same to the port and to the reference."""

from __future__ import annotations

import numpy as np

from benchmark.lib.spec import ROOT


def load_flat(cfg: dict) -> dict:
    """{JAX path: float32 array} from the config's ``weights`` file (a path
    from the root of the checkout); keys that start with "_" are the copy's
    metadata, not weights."""
    with np.load(ROOT / cfg["weights"]) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files
                if not k.startswith("_")}


def tree(flat: dict) -> dict:
    """{"a/b": v} -> {"a": {"b": v}}, the nested form the port takes."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def count(flat: dict) -> int:
    return int(sum(v.size for v in flat.values()))
