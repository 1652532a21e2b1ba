"""One training epoch (counterpart of
``centroids_reid_tpu/engine/epoch_runner.py``): a plain Python loop over
the plan's steps, each of which augments its batch on the card and takes a
train step. Two batch sources feed it:

* ``resident_batches``: the image bank on the card (``data/device_data``);
  each step gathers its P x K rows with ``index_select``;
* ``streamed_batches``: the host ``TrainLoader``'s uint8 batches, copied to
  the card from pinned memory without blocking.

The step metrics are summed on the card; the caller reads their means with
one host sync per epoch. (The JAX package's ``lax.scan``, step padding and
ahead-of-time compile exist for XLA and have no counterpart here.)
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from ..data.transforms import augment_batch
from ..utils import annotate

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def make_augment(cfg) -> Callable:
    """``augment(imgs_u8, is_real, generator)``: the config's training
    augmentation, in bf16 when ``USE_MIXED_PRECISION``."""
    size_hw = tuple(cfg.INPUT.SIZE_TRAIN)
    dtype = torch.bfloat16 if cfg.USE_MIXED_PRECISION else torch.float32
    consts = {}   # device -> (mean, std): copied there once, not per step

    def augment(imgs_u8, is_real, generator):
        dev = imgs_u8.device
        if dev not in consts:
            consts[dev] = tuple(
                torch.tensor(v, dtype=torch.float32, device=dev)
                for v in (cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD))
        return augment_batch(imgs_u8, is_real, generator, size_hw,
                             cfg.INPUT.PADDING, *consts[dev], cfg.INPUT.PROB,
                             cfg.INPUT.RE_PROB, dtype=dtype)

    return augment


def resident_batches(bank: torch.Tensor, idx: torch.Tensor,
                     labels: torch.Tensor, is_real: torch.Tensor
                     ) -> Iterator[Batch]:
    """bank [N, H, W, 3] uint8 and the plan's idx / labels / is_real
    [S, P*K], all on the card -> each step's (images, labels, is_real)."""
    for t in range(idx.shape[0]):
        with annotate("gather"):
            imgs = bank.index_select(0, idx[t])
        yield imgs, labels[t], is_real[t]


def streamed_batches(batches: Iterable[dict], device) -> Iterator[Batch]:
    """The TrainLoader's numpy batches on ``device``: pinned host memory and
    copies that do not block the host when it is the card."""
    device = torch.device(device)
    for b in batches:
        with annotate("host_to_device"):
            out = []
            for name in ("images", "labels", "is_real"):
                t = torch.from_numpy(np.ascontiguousarray(b[name]))
                if device.type == "cuda":
                    t = t.pin_memory()
                out.append(t.to(device, non_blocking=True))
        yield tuple(out)


def run_epoch(train_step: Callable, batches: Iterable[Batch],
              augment: Callable, generator: torch.Generator
              ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Augment and step every batch; returns (the mean of each step metric,
    a tensor on the card, and the number of steps)."""
    sums: Dict[str, torch.Tensor] = {}
    n = 0
    for imgs, labels, is_real in batches:
        with annotate("augment"):
            x = augment(imgs, is_real, generator)
        metrics = train_step(x, labels, is_real)
        for name, v in metrics.items():
            sums[name] = sums[name] + v if name in sums else v
        n += 1
    return {name: v / max(n, 1) for name, v in sums.items()}, n
