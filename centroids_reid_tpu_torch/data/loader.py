"""Host-side eval batches with background prefetch (counterpart of
``ImageStore`` and ``EvalLoader`` in ``centroids_reid_tpu/data/loader.py``).

The host decodes and resizes (optionally from an in-RAM uint8 cache); a
background thread assembles the next uint8 batch while the card embeds
the current one. RGB only: the packed-YUV420 fast ingest is not ported
yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .datasets import Record
from .transforms import load_and_resize


class ImageStore:
    """Decoded-and-resized uint8 [H, W, 3] images with an optional RAM
    cache. ``fmt="yuv420"`` (the fast serving ingest) raises
    ``NotImplementedError``."""

    def __init__(self, size_hw: Tuple[int, int], cache: bool = True,
                 fmt: str = "rgb"):
        if fmt == "yuv420":
            raise NotImplementedError(
                "the yuv420 ImageStore (TPU.FAST_DECODE) is not ported yet; "
                "see ROADMAP.md queue 1 item 6 (fast ingest)")
        if fmt != "rgb":
            raise ValueError(f"unknown ImageStore fmt {fmt!r}")
        self.size_hw = tuple(int(v) for v in size_hw)
        self.cache_enabled = cache
        self.fmt = fmt
        self._cache: Dict[str, np.ndarray] = {}

    def item_shape(self) -> Tuple[int, ...]:
        return (*self.size_hw, 3)

    def get(self, path: str) -> np.ndarray:
        if self.cache_enabled:
            img = self._cache.get(path)
            if img is None:
                img = load_and_resize(path, self.size_hw)
                self._cache[path] = img
            return img
        return load_and_resize(path, self.size_hw)

    def get_many(self, paths: List[str], out: np.ndarray,
                 n_threads: int = 0) -> None:
        """Fill ``out[i]`` for each path: cache hits copied, misses decoded
        through the native batch entry (threads scale with host cores;
        the same bytes as ``get``). Images the native decoder declines, or
        all of them when it is unavailable, take the per-image path."""
        from .. import native

        missing = []
        for i, p in enumerate(paths):
            img = self._cache.get(p) if self.cache_enabled else None
            if img is None:
                missing.append(i)
            else:
                out[i] = img
        if not missing:
            return
        blobs = []
        for i in missing:
            try:
                with open(paths[i], "rb") as f:
                    blobs.append(f.read())
            except OSError:
                blobs.append(b"")
        res = native.decode_resize_batch(blobs, self.size_hw,
                                         n_threads=n_threads)
        if res is None:  # native library unavailable: per-image path
            for i in missing:
                out[i] = self.get(paths[i])
            return
        decoded, failed = res
        failed = set(failed)
        for j, i in enumerate(missing):
            if j in failed:
                out[i] = load_and_resize(paths[i], self.size_hw)  # PIL
            else:
                out[i] = decoded[j]
            if self.cache_enabled:
                self._cache[paths[i]] = out[i].copy()


class EvalLoader:
    """Sequential batches over query + gallery records.

    Yields dicts of images uint8 [B, H, W, 3], pids, camids and a valid
    mask; the last batch is zero-padded to the batch size with valid=False
    tails."""

    def __init__(self, records: List[Record], cfg,
                 batch_size: Optional[int] = None, prefetch: int = 2,
                 store: Optional[ImageStore] = None):
        self.records = records
        self.batch_size = batch_size or cfg.TEST.IMS_PER_BATCH
        self.store = store or ImageStore(cfg.INPUT.SIZE_TEST,
                                         cfg.TPU.CACHE_IMAGES)
        self.n_threads = cfg.TPU.PREFETCH_THREADS
        self.prefetch = prefetch

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

    def _assemble(self, start: int) -> dict:
        b = self.batch_size
        chunk = self.records[start:start + b]
        images = np.zeros((b, *self.store.item_shape()), np.uint8)
        pids = np.zeros((b,), np.int64)
        camids = np.zeros((b,), np.int64)
        valid = np.zeros((b,), bool)
        self.store.get_many([rec.path for rec in chunk], images[:len(chunk)],
                            n_threads=self.n_threads)
        for i, rec in enumerate(chunk):
            pids[i] = rec.pid
            camids[i] = rec.camid
            valid[i] = True
        return {"images": images, "pids": pids, "camids": camids,
                "valid": valid}

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: list = []

        def producer():
            try:
                for start in range(0, len(self.records), self.batch_size):
                    if stop.is_set():
                        return
                    q.put(self._assemble(start))
            except BaseException as e:  # re-raised in the consumer
                failure.append(e)
            q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()
