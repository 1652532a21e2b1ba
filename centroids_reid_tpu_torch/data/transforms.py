"""Image transforms: host decode + resize, and on the device the eval
normalise and the training augmentation.

Counterpart of ``centroids_reid_tpu/data/transforms.py``
(``decode_and_resize_bytes``, ``load_and_resize``, the fast ingest's
``decode_and_pack_yuv420_bytes``, ``load_and_pack_yuv420``,
``yuv420_to_rgb`` and ``normalize_yuv420_batch``, ``ingest_item_shape``,
``ingest_blobs``, ``normalize_batch`` and ``augment_batch``). The native
JPEG decoder is the port's own copy (``centroids_reid_tpu_torch/native``).

The fast serving ingest (``TPU.FAST_DECODE``) ships packed planar YUV420,
1.5 bytes a pixel instead of 3: the host decodes (DCT-scaled where the
native decoder runs), resizes and packs (``native.rgb_to_yuv420``), and the
device unpacks inside the embed (``yuv420_to_rgb``: libjpeg's 3/4-1/4
chroma upsample, then the full-range BT.601 inverse). The packing is lossy
(4:2:0 chroma), so it is a serving option; evaluation stays on RGB.

The training augmentation is the reference's torchvision chain on uint8
[H, W, 3] batches: horizontal flip, zero pad + random crop, normalise,
random erasing in normalised space filled with ``PIXEL_MEAN``, then mock
slots zeroed. It is split in two: ``draw_augment_params`` draws every
image's flip, crop offset, erase decision and rectangle from a
``torch.Generator``, and ``apply_augment`` is a pure, batched function of
those draws (an index gather for flip + crop, a mask for the erase). The
draws cannot equal the JAX package's ``jax.random`` stream; the function of
the draws equals its ``augment_batch``.

Erasing draws ``_N_ERASE_DRAWS`` candidate rectangles per image and takes
the first that fits (the reference retries up to 100 times); its top-left
corner is ``floor(u * (h - eh + 1))``, as in the JAX package.
"""

from __future__ import annotations

import io
from typing import NamedTuple, Optional, Sequence, Tuple

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


def decode_and_pack_yuv420_bytes(data: bytes,
                                 size_hw: Tuple[int, int]) -> np.ndarray:
    """Encoded image bytes -> packed planar YUV420 uint8 [1.5 * H * W]:
    the native decoder's DCT-scaled decode, resize and pack, or for
    anything it declines (and everything without it) the exact PIL decode
    and bilinear resize, packed by ``native.rgb_to_yuv420_np``."""
    from ..native import decode_fast, rgb_to_yuv420_np

    out = decode_fast(data, size_hw)
    if out is not None:
        return out
    return rgb_to_yuv420_np(decode_and_resize_bytes(data, size_hw))


def load_and_pack_yuv420(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """File variant of ``decode_and_pack_yuv420_bytes`` (the offline fast
    ingest)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_and_pack_yuv420_bytes(data, size_hw)


def ingest_item_shape(fmt: str, size_hw: Tuple[int, int]) -> Tuple[int, ...]:
    """Per-image uint8 shape of a serving wire format: packed planar YUV420
    ``[1.5 * H * W]`` or RGB ``[H, W, 3]`` (the shape the HTTP server's
    warm-up batches take)."""
    h, w = (int(v) for v in size_hw)
    if fmt == "yuv420":
        return (h * w * 3 // 2,)
    return (h, w, 3)


def ingest_blobs(fmt: str, size_hw: Tuple[int, int],
                 blobs: Sequence[bytes]) -> np.ndarray:
    """Encoded image bytes -> the uint8 batch a serving query takes, shape
    ``[B, *ingest_item_shape(fmt, size_hw)]``. Host work only."""
    size = tuple(int(v) for v in size_hw)
    if fmt == "yuv420":
        return np.stack([decode_and_pack_yuv420_bytes(b, size)
                         for b in blobs])
    if fmt != "rgb":
        raise ValueError(f"unknown ingest format {fmt!r}")
    return np.stack([decode_and_resize_bytes(b, size) for b in blobs])


def normalize_batch(imgs_u8: torch.Tensor, mean, std,
                    dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> ``(x / 255 - mean) / std`` in fp32, cast to
    ``dtype``. Layout is kept (NHWC in, NHWC out)."""
    m = torch.tensor(mean, dtype=torch.float32, device=imgs_u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=imgs_u8.device)
    return ((imgs_u8.float() / 255.0 - m) / s).to(dtype)


def yuv420_to_rgb(packed_u8: torch.Tensor,
                  size_hw: Tuple[int, int]) -> torch.Tensor:
    """Packed YUV420 uint8 [..., 1.5 * H * W] -> RGB fp32 [..., H, W, 3] in
    [0, 255] on the input's device: libjpeg's chroma upsample (the triangle
    filter, weights 3/4 and 1/4 along each axis, edges replicated), then
    the full-range BT.601 inverse of ``native.rgb_to_yuv420_np``.

    The triangle filter at twice the size is bilinear resampling at pixel
    centres, so both chroma planes take one ``F.interpolate``; its weight
    products (9/16, 3/16, 1/16) of 8-bit values are exact in fp32, so the
    result equals the reference's separable upsample bit for bit."""
    import torch.nn.functional as F

    h, w = (int(v) for v in size_hw)
    hw = h * w
    lead = packed_u8.shape[:-1]
    y = packed_u8[..., :hw].reshape(*lead, h, w).float()
    uv = packed_u8[..., hw:].reshape(-1, 2, h // 2, w // 2).float()
    uv = F.interpolate(uv, scale_factor=2, mode="bilinear",
                       align_corners=False).reshape(*lead, 2, h, w) - 128.0
    u, v = uv.unbind(-3)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def normalize_yuv420_batch(packed_u8: torch.Tensor, size_hw, mean, std,
                           dtype=torch.float32) -> torch.Tensor:
    """Packed YUV420 uint8 [B, 1.5 * H * W] -> normalised [B, H, W, 3]
    ``(rgb / 255 - mean) / std``, cast to ``dtype``."""
    rgb = yuv420_to_rgb(packed_u8, size_hw)
    m = torch.tensor(mean, dtype=torch.float32, device=rgb.device)
    s = torch.tensor(std, dtype=torch.float32, device=rgb.device)
    return ((rgb / 255.0 - m) / s).to(dtype)


_N_ERASE_DRAWS = 8


class AugmentParams(NamedTuple):
    """One batch's augmentation draws, N images.

    flip:   [N] bool
    offset: [N, 2] int64, the crop's (row, column) in the padded image
    erase:  [N] bool, erase decision and a rectangle that fits
    rect:   [N, 4] int64, the rectangle's (y0, x0, height, width)
    """

    flip: torch.Tensor
    offset: torch.Tensor
    erase: torch.Tensor
    rect: torch.Tensor


def erase_rectangles(target_area, aspect, uy, ux, size_hw: Tuple[int, int]):
    """Candidate rectangles [N, D] (areas in pixels, aspect ratios) and the
    corner uniforms [N] -> (rect [N, 4] int64, any_valid [N] bool): the first
    candidate that fits, sides clamped to (h - 1, w - 1), corner
    ``floor(u * (side_room + 1))``."""
    h, w = size_hw
    eh = torch.round(torch.sqrt(target_area * aspect)).long()
    ew = torch.round(torch.sqrt(target_area / aspect)).long()
    valid = (eh < h) & (ew < w)
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)  # 0 if none
    eh0 = eh.gather(1, first)[:, 0].clamp_max(h - 1)
    ew0 = ew.gather(1, first)[:, 0].clamp_max(w - 1)
    y0 = (uy * (h - eh0 + 1).float()).long()
    x0 = (ux * (w - ew0 + 1).float()).long()
    return torch.stack([y0, x0, eh0, ew0], dim=1), valid.any(dim=1)


def draw_augment_params(n: int, generator: torch.Generator,
                        size_hw: Tuple[int, int], padding: int,
                        flip_p: float, re_p: float) -> AugmentParams:
    """Every draw of one batch of ``n`` images, on ``generator``'s device.
    The erase decision is drawn apart from its rectangle, so the threshold
    ``re_p`` never moves a rectangle."""
    h, w = size_hw
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    flip = uniform(n) < flip_p
    offset = torch.randint(0, 2 * padding + 1, (n, 2), generator=generator,
                           device=dev)
    do_erase = uniform(n) < re_p
    target_area = (0.02 + (0.4 - 0.02) * uniform(n, _N_ERASE_DRAWS)) * (h * w)
    aspect = 0.3 + (1.0 / 0.3 - 0.3) * uniform(n, _N_ERASE_DRAWS)
    rect, any_valid = erase_rectangles(target_area, aspect, uniform(n),
                                       uniform(n), size_hw)
    return AugmentParams(flip, offset, do_erase & any_valid, rect)


def apply_augment(imgs_u8: torch.Tensor, is_real: torch.Tensor,
                  params: AugmentParams, padding: int, mean, std,
                  dtype=torch.float32) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> normalised, augmented [N, H, W, 3] of
    ``dtype``, mock rows (``is_real`` False) exactly zero. Runs where the
    images are; ``params`` must be there too, and so should ``mean`` and
    ``std`` when they are tensors (a sequence is copied there, which waits
    for the card)."""
    n, h, w, _ = imgs_u8.shape
    dev = imgs_u8.device
    rows = (torch.arange(h, device=dev)[None, :] + params.offset[:, :1]
            - padding)                                        # [N, H]
    cols = (torch.arange(w, device=dev)[None, :] + params.offset[:, 1:]
            - padding)                                        # [N, W]
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])      # [N, H, W]
    # the flip comes before the pad: a crop column reads the mirrored one
    cols = torch.where(params.flip[:, None], w - 1 - cols, cols)
    src = imgs_u8[torch.arange(n, device=dev)[:, None, None],
                  rows.clamp(0, h - 1)[:, :, None],
                  cols.clamp(0, w - 1)[:, None, :]]           # [N, H, W, 3]
    x = torch.where(inside[..., None], src, 0).float()
    m = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    x = (x / 255.0 - m) / torch.as_tensor(std, dtype=torch.float32, device=dev)
    y0, x0, eh, ew = params.rect.unbind(dim=1)
    r = torch.arange(h, device=dev)[None, :]
    c = torch.arange(w, device=dev)[None, :]
    in_rect = (((r >= y0[:, None]) & (r < (y0 + eh)[:, None]))[:, :, None]
               & ((c >= x0[:, None]) & (c < (x0 + ew)[:, None]))[:, None, :])
    x = torch.where((in_rect & params.erase[:, None, None])[..., None], m, x)
    x = torch.where(is_real[:, None, None, None], x, 0.0)
    return x.to(dtype)


def augment_batch(imgs_u8: torch.Tensor, is_real: torch.Tensor,
                  generator: torch.Generator, size_hw: Tuple[int, int],
                  padding: int, mean, std, flip_p: float, re_p: float,
                  dtype=torch.float32,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Draw, then apply: the training augmentation of one batch. With
    ``rows=(start, total)`` the draws are those of a batch of ``total``
    images whose rows ``start, start + 1, ...`` are ``imgs_u8``: a process
    of a data-parallel run draws for the global [G, P*K] grid and keeps
    its groups' rows, so its images are augmented as in a one-process run
    of the same G (the JAX package's resident policy: one key for every
    process, split per image over the global grid)."""
    n = imgs_u8.shape[0]
    start, total = rows or (0, n)
    params = draw_augment_params(total, generator, size_hw, padding, flip_p,
                                 re_p)
    if total != n:
        params = AugmentParams(*(f[start:start + n] for f in params))
    return apply_augment(imgs_u8, is_real, params, padding, mean, std, dtype)
