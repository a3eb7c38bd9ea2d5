"""Datasets: a directory of high-resolution PNGs, and a stream of images
from a caller's source (JAX counterpart:
transformerupscaler_tpu/data/datasets.py).

- ``HighresImageDataset``: every image expands into the ten fixed LR -> HR
  scale pairs (``resolutions.SCALE_PAIRS``, or ``scale_pairs``);
  ``__len__`` is ``length`` (200) capped at images x pairs, as JAX caps
  it. Samples are HWC float32 in [0, 1], uint8 / 255 as the JAX package
  computes them, or with ``uint8`` the uint8 pixels.
- ``OnlineHighresDataset``: a deque of images refilled by a background
  thread from ``fetch_fn`` (HWC uint8), each image serving every scale
  pair before it is dropped; ``__len__`` 500.

The JAX package decodes with PIL and resizes with PIL's antialiased
bilinear filter. Here PNGs are read by ``png.read_png`` (bit for bit
PIL's ``convert("RGB")``) and resized by ``native.resize_bilinear_u8``,
PIL's filter in C++, whose uint8 pixels are within one level of PIL's
(its final rounding may differ; the bound the JAX package's
tests/test_native.py holds its own copy to). The card's host has no PIL,
no JPEG decoder and no network: the online dataset's network fetch and
``.jpg`` files in ``fallback_dir`` raise, never a silent download (the
JAX default fetches from picsum.photos).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from transformerupscaler_torch.native import resize_bilinear_u8
from transformerupscaler_torch.png import read_png
from transformerupscaler_torch.resolutions import SCALE_PAIRS


def _resize(img: np.ndarray, hw: tuple[int, int],
            uint8: bool = False) -> np.ndarray:
    """HWC uint8 -> PIL-bilinear resize to (H, W): uint8, or float32
    uint8 / 255 (one f32 division, as the JAX package's ``_resize_pil``)."""
    out = resize_bilinear_u8(img, hw)
    if uint8:
        return out
    return out.astype(np.float32) / np.float32(255.0)


class HighresImageDataset:
    """Local directory of .png images, expanded into the scale pairs."""

    def __init__(self, image_dir: str, length: int = 200, scale_pairs=None,
                 cache: bool = False, uint8: bool = False):
        self.image_dir = image_dir
        self.image_files = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)
            if f.lower().endswith(".png"))
        self.scale_pairs = list(scale_pairs if scale_pairs is not None
                                else SCALE_PAIRS)
        self._length = length
        self._cache: dict | None = {} if cache else None
        self._uint8 = uint8

    def __len__(self) -> int:
        # The reference hardcodes 200 (data_class.py:47-50), out of range
        # for fewer than 20 images: capped as the JAX package caps it.
        return min(self._length, len(self.image_files) * len(self.scale_pairs))

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        n = len(self.scale_pairs)
        hr_image = read_png(self.image_files[idx // n])
        pair = self.scale_pairs[idx % n]
        item = (_resize(hr_image, pair["lr"], self._uint8),
                _resize(hr_image, pair["hr"], self._uint8))
        if self._cache is not None:
            self._cache[idx] = item
        return item

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _png_source(fallback_dir: str):
    """A fetch function cycling through the PNGs of ``fallback_dir`` in
    sorted order."""
    names = sorted(os.listdir(fallback_dir))
    jpgs = [f for f in names if f.lower().endswith(".jpg")]
    if jpgs:
        raise NotImplementedError(
            f"{fallback_dir} holds .jpg files ({jpgs[:3]}...): the port reads "
            f"PNGs only, its host has no JPEG decoder (ROADMAP.md section 1)")
    files = [os.path.join(fallback_dir, f) for f in names
             if f.lower().endswith(".png")]
    if not files:
        raise ValueError(f"no .png files in {fallback_dir}")
    lock = threading.Lock()
    counter = {"i": 0}

    def fetch():
        with lock:
            path = files[counter["i"] % len(files)]
            counter["i"] += 1
        return read_png(path)

    return fetch


class OnlineHighresDataset:
    """Streaming dataset over a background-refilled image cache.

    ``fetch_fn()`` returns one HWC uint8 RGB image, or None to skip;
    ``fallback_dir`` feeds the PNGs of a directory instead. With neither it
    raises: the port has no network fetch (the card's host has no network
    and no JPEG decoder)."""

    def __init__(self, fetch_fn=None, fallback_dir: str | None = None,
                 batch_download_count: int = 50, minimum_cache: int = 10,
                 length: int = 500, max_workers: int = 8):
        if fetch_fn is None and fallback_dir is None:
            raise ValueError(
                "OnlineHighresDataset needs fetch_fn or fallback_dir: the "
                "port has no network fetch (the JAX default downloads JPEGs "
                "from picsum.photos; the card's host has no network and no "
                "JPEG decoder, ROADMAP.md section 1)")
        self.scale_pairs = list(SCALE_PAIRS)
        self.num_scale_pairs = len(self.scale_pairs)
        self.batch_download_count = batch_download_count
        self.minimum_cache = minimum_cache
        self._length = length
        self._max_workers = max_workers
        self.fetch_fn = fetch_fn or _png_source(fallback_dir)
        self.cache: deque = deque()
        self.lock = threading.Lock()
        self.stop_event = threading.Event()
        self.thread = threading.Thread(target=self._download_loop,
                                       daemon=True)
        self.thread.start()

    def _download_batch(self):
        with ThreadPoolExecutor(max_workers=self._max_workers) as ex:
            for img in ex.map(lambda _: self.fetch_fn(),
                              range(self.batch_download_count)):
                if img is not None:
                    with self.lock:
                        self.cache.append((img, 0))

    def _download_loop(self):
        while not self.stop_event.is_set():
            with self.lock:
                n = len(self.cache)
            if n < self.minimum_cache:
                self._download_batch()
            else:
                time.sleep(0.1)

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        while True:
            with self.lock:
                if self.cache:
                    img, used = self.cache[0]
                    break
            if not self.thread.is_alive():
                raise RuntimeError("OnlineHighresDataset: the fetch thread "
                                   "stopped with the cache empty")
            time.sleep(0.05)
        pair = self.scale_pairs[used]
        lr = _resize(img, pair["lr"])
        hr = _resize(img, pair["hr"])
        with self.lock:
            used += 1
            if used >= self.num_scale_pairs:
                self.cache.popleft()
            else:
                self.cache[0] = (img, used)
        return lr, hr

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        self.stop_event.set()
        if self.thread.is_alive():
            self.thread.join(timeout=5)

    def __del__(self):
        try:
            self.stop_event.set()
        except AttributeError:  # __init__ raised before the event existed
            pass
