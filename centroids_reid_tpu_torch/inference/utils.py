"""Offline-inference helpers: folder listing, batched embedding, centroids
(counterpart of ``centroids_reid_tpu/inference/utils.py``).

Flat-folder and subfolder image listings, ``bn(GAP(trunk(x)))``
embeddings on the model's device, a pid -> paths index through a
configurable extractor, and group-mean centroid index construction.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..data.datasets import Record
from ..data.loader import EvalLoader, ImageStore
from ..engine.evaluate import extract_embeddings, make_embed_fn

log = logging.getLogger(__name__)

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


def serving_ingest_format(cfg) -> str:
    """'yuv420' when the fast serving ingest (``TPU.FAST_DECODE``) is on and
    usable, else 'rgb', as the reference decides. An int8 embed consumes
    RGB; YUV420 needs an even ``SIZE_TEST`` and the native decoder (without
    it the exact RGB path serves)."""
    if not cfg.TPU.FAST_DECODE:
        return "rgb"
    if cfg.TPU.INT8_EVAL:
        log.info("TPU.FAST_DECODE skipped: int8 serving consumes RGB")
        return "rgb"
    from ..native import fast_available

    size = tuple(cfg.INPUT.SIZE_TEST)
    if not fast_available(size):
        log.warning(f"TPU.FAST_DECODE unavailable for SIZE_TEST={size} (odd "
                    "dims or native decoder missing); using the exact path")
        return "rgb"
    return "yuv420"


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def list_images_flat(path: str) -> List[str]:
    """Images directly under ``path`` (or ``path`` itself if an image)."""
    if os.path.isdir(path):
        return [os.path.join(path, f) for f in sorted(os.listdir(path))
                if is_image_file(f)]
    if is_image_file(path):
        return [path]
    raise RuntimeError(
        f"{path} is neither a valid image file nor a folder containing images")


def list_images_subfolders(path: str) -> List[str]:
    """Images under class subfolders, ImageFolder-style ordering."""
    out = []
    for cls in sorted(os.listdir(path)):
        sub = os.path.join(path, cls)
        if not os.path.isdir(sub):
            continue
        out.extend(os.path.join(sub, f) for f in sorted(os.listdir(sub))
                   if is_image_file(f))
    if not out:
        raise RuntimeError(f"no images found under subfolders of {path}")
    return out


def pid_from_filename(path: str) -> str:
    """/dir/product001_04.jpg -> product001"""
    return os.path.basename(path).rsplit(".", 1)[0].rsplit("_", 1)[0]


def pid_from_parent_dir(path: str) -> str:
    """/data/001/image_04.jpg -> 001"""
    return Path(path).parent.name


PID_EXTRACTORS: Dict[str, Callable[[str], str]] = {
    "parent_dir": pid_from_parent_dir,
    "filename": pid_from_filename,
}


def run_inference(model, cfg, image_paths: List[str], print_freq: int = 10,
                  embed_fn=None, store=None) -> Tuple[np.ndarray, np.ndarray]:
    """Embed a list of images on the model's device; returns (embeddings
    [N, D] fp32, paths [N]). ``embed_fn(imgs_u8)`` replaces the bf16 / fp32
    embed (the int8 serving path, which takes RGB); ``store`` shares
    decoded images with e.g. the calibration pass. With
    ``TPU.FAST_DECODE`` (and no ``embed_fn``) batches travel as packed
    YUV420 and the embed unpacks them on the card."""
    if store is None:
        fmt = serving_ingest_format(cfg) if embed_fn is None else "rgb"
        store = ImageStore(tuple(cfg.INPUT.SIZE_TEST), cfg.TPU.CACHE_IMAGES,
                           fmt=fmt)
    elif store.fmt == "yuv420" and embed_fn is not None:
        raise ValueError(
            "run_inference: a yuv420 store cannot feed a custom embed_fn "
            "(custom fns consume uint8 RGB batches)")
    records = [Record(p, 0, 0, i) for i, p in enumerate(image_paths)]
    loader = EvalLoader(records, cfg, store=store)
    log.info(f"Embedding {len(records)} images in {len(loader)} batches of "
             f"{loader.batch_size} (progress every {print_freq} batches)")
    embed = embed_fn or make_embed_fn(model, cfg, input_format=store.fmt)
    embeddings, _, _ = extract_embeddings(model, cfg, loader, embed_fn=embed)
    return embeddings, np.asarray(image_paths)


def create_pid_path_index(paths: List[str],
                          func: Callable[[str], str]) -> Dict[str, list]:
    index: Dict[str, list] = {}
    for idx, path in enumerate(paths):
        index.setdefault(func(path), []).append(idx)
    return index


def calculate_centroids(embeddings: np.ndarray, pid_path_index: Dict[str, list]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Group-mean centroids; returns (centroids, pid strings)."""
    pids, cents = [], []
    for pid, indices in pid_path_index.items():
        cents.append(embeddings[np.asarray(indices)].mean(axis=0))
        pids.append(pid)
    return np.vstack(cents), np.asarray(pids, dtype=np.str_)
