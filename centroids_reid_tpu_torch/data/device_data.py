"""Device-resident training data: the whole train set on the card
(counterpart of ``centroids_reid_tpu/data/device_data.py``).

Re-id train sets are small (Market-1501: 12,936 x 256x128x3 uint8 = 1.27
GB), so the decoded image bank is uploaded to the card once, and each step
gathers its planned P x K rows there with ``index_select``: no host decode
and no host-to-device copy per step.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .datasets import Record
from .loader import ImageStore
from .sampler import EpochPlan


def build_image_bank(
    records: List[Record], size_hw: Tuple[int, int], cache: bool = True,
    num_workers: int = 0,
) -> np.ndarray:
    """Decode+resize every record once -> uint8 [N, H, W, 3].

    ``num_workers`` threads decode in parallel (PIL releases the GIL in the
    JPEG decoder); 0 means one thread per available CPU, at most 32: the
    reference's DataLoader worker parallelism, paid once instead of per
    epoch.
    """
    import concurrent.futures
    import os

    from ..native import available, decode_resize_batch

    h, w = size_hw
    bank = np.zeros((len(records), h, w, 3), np.uint8)
    workers = num_workers or min(32, os.cpu_count() or 1)

    # native path: threaded C++ decode straight into the bank (bit-exact
    # with PIL); what it declines is decoded below through PIL. The bytes
    # are read here only when the native library exists.
    todo = list(range(len(records)))
    if available():
        blobs = []
        for rec in records:
            with open(rec.path, "rb") as f:
                blobs.append(f.read())
        res = decode_resize_batch(blobs, size_hw, out=bank,
                                  n_threads=workers)
        if res is not None:
            _, todo = res
        del blobs

    store = ImageStore(size_hw, cache=cache)

    def fill(i):
        bank[i] = store.get(records[i].path)

    if len(todo) > 1 and workers > 1:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(fill, todo))
    else:
        for i in todo:
            fill(i)
    return bank


def bank_size_mb(records: List[Record], size_hw: Tuple[int, int]) -> float:
    h, w = size_hw
    return len(records) * h * w * 3 / 1e6


def plan_to_arrays(plan: EpochPlan, records: List[Record]):
    """EpochPlan -> dense per-step arrays for the device-resident epoch.

    Returns (sample_idx [steps, G, P*K] int32, labels [steps, G, P*K] int32,
    is_real [steps, G, P*K] bool).
    """
    steps, g, p, k = plan.sample_idx.shape
    idx = plan.sample_idx.reshape(steps, g, p * k).astype(np.int32)
    pids = np.asarray([r.pid for r in records], np.int32)
    labels = pids[idx]
    is_real = plan.is_real.reshape(steps, g, p * k)
    return idx, labels, is_real
