"""Eval and serving image transforms: host decode + resize, device
normalise.

Counterpart of the eval half of ``centroids_reid_tpu/data/transforms.py``
(``decode_and_resize_bytes``, ``load_and_resize``, the RGB branch of
``ingest_blobs`` and ``normalize_batch``). The native JPEG decoder is the
port's own copy (``centroids_reid_tpu_torch/native``).
"""

from __future__ import annotations

import io
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def available_decoder() -> Optional[str]:
    """'native' (g++ + libjpeg build of ``centroids_reid_tpu_torch.native``),
    'pil', or None when neither can decode."""
    from .. import native

    if native.available():
        return "native"
    return "pil" if _pil() is not None else None


def decode_and_resize_bytes(data: bytes,
                            size_hw: Tuple[int, int]) -> np.ndarray:
    """Encoded image bytes -> RGB uint8 [H, W, 3], bilinear resize.

    JPEGs take the native decoder when it is built (bit-exact with PIL);
    anything it declines, or every image when it is unavailable, goes to
    PIL. Raises when neither is available."""
    from ..native import decode_resize

    out = decode_resize(data, size_hw)
    if out is not None:
        return out
    image = _pil()
    if image is None:
        raise RuntimeError(
            "no image decoder: the native JPEG decoder is not built (needs "
            "g++ and libjpeg headers) and Pillow is not installed"
        )
    img = image.open(io.BytesIO(data)).convert("RGB")
    h, w = size_hw
    return np.asarray(img.resize((w, h), image.BILINEAR), np.uint8)


def load_and_resize(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """File variant of ``decode_and_resize_bytes`` (the eval and offline
    loaders)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_and_resize_bytes(data, size_hw)


def ingest_blobs(fmt: str, size_hw: Tuple[int, int],
                 blobs: Sequence[bytes]) -> np.ndarray:
    """Encoded image bytes -> uint8 RGB batch [B, H, W, 3]."""
    if fmt != "rgb":
        raise NotImplementedError(
            f"ingest format {fmt!r} (TPU.FAST_DECODE) is not ported yet; "
            "see ROADMAP.md, queue 1 (fast ingest)"
        )
    size = tuple(int(v) for v in size_hw)
    return np.stack([decode_and_resize_bytes(b, size) for b in blobs])


def normalize_batch(imgs_u8: torch.Tensor, mean, std,
                    dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> ``(x / 255 - mean) / std`` in fp32, cast to
    ``dtype``. Layout is kept (NHWC in, NHWC out)."""
    m = torch.tensor(mean, dtype=torch.float32, device=imgs_u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=imgs_u8.device)
    return ((imgs_u8.float() / 255.0 - m) / s).to(dtype)
