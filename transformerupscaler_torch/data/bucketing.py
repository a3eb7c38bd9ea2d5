"""Geometry bucketing: group a batch's (lr, hr) samples by shape (JAX
counterpart: transformerupscaler_tpu/data/bucketing.py).

A batch mixes the ten LR -> HR geometries; each geometry's samples stack
into one NHWC batch that runs one batched forward. ``batched`` shuffles
with ``np.random.default_rng(seed)`` as the JAX package does, so that the
same seed gives the same batches in both.
"""

from __future__ import annotations

import queue
import threading
from collections import defaultdict

import numpy as np
import torch


def _stack(arrays):
    """numpy arrays stack with numpy; tensors (already on the card, as the
    trainer's device cache keeps them) with ``torch.stack``, so that
    nothing is pulled back to the host."""
    if isinstance(arrays[0], torch.Tensor):
        return torch.stack(arrays)
    return np.stack(arrays)


def bucket_batch(samples) -> dict:
    """samples: iterable of (lr HWC, hr HWC) -> {((lr_h, lr_w), (hr_h,
    hr_w)): (lr NHWC, hr NHWC)}, in the order each geometry first
    appears."""
    groups = defaultdict(list)
    for lr, hr in samples:
        groups[(tuple(lr.shape[:2]), tuple(hr.shape[:2]))].append((lr, hr))
    return {key: (_stack([p[0] for p in pairs]), _stack([p[1] for p in pairs]))
            for key, pairs in groups.items()}


def batched(dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
            drop_last: bool = False):
    """Yield lists of ``batch_size`` samples of ``dataset``."""
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    batch = []
    for i in idx:
        batch.append(dataset[int(i)])
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


def prefetched(iterator, depth: int = 2):
    """Run ``iterator`` in a background thread, up to ``depth`` items
    ahead, so that the host's decode and resize overlap the device's steps.
    An exception in the iterator is raised here, where the items are
    taken."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    failure = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            failure.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        yield item
    t.join()
    if failure:
        raise failure[0]
