"""Native (C++) ingest path: JPEG decode + Pillow-bit-exact resize.

The port's own copy of ``centroids_reid_tpu/native`` (the port imports
nothing of the JAX package). The shared library is built from
``decode.cpp`` on first use with the system toolchain (g++ + libjpeg) and
cached under a name of its own (``crt_torch_decode_<tag>.so``), so it never
loads the JAX package's build. Every entry point degrades to the PIL path
transparently:

* toolchain or libjpeg missing -> ``available()`` is False, callers use PIL;
* an individual image the native decoder refuses (CMYK, corrupt, ...)
  -> per-image fallback to PIL.

Bit-exactness vs PIL (decode: same libjpeg-turbo defaults; resize: a port
of Pillow's fixed-point triangle-filter resample) is asserted by
the JAX package's tests/test_native.py (and, for this copy, by its
load-time self-check), so the two paths are interchangeable mid-dataset.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sys
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "decode.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build_dir() -> str:
    """Per-user, mode-0700 build cache. The .so path is predictable, so a
    shared world-writable directory would let another local user plant a
    library that ctypes would happily load — refuse any cache dir we do
    not exclusively own."""
    d = os.environ.get("CRT_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(), f"crt_native_{os.getuid()}"
    )
    os.makedirs(d, mode=0o700, exist_ok=True)
    st = os.stat(d)
    if st.st_uid != os.geteuid() or (st.st_mode & 0o022):
        raise RuntimeError(
            f"native build cache {d} is not exclusively owned by this user"
        )
    return d


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if os.environ.get("CRT_NO_NATIVE"):
            _build_failed = True
            return None
        try:
            with open(_SRC, "rb") as f:
                tag = hashlib.sha256(
                    f.read() + sys.version.encode()
                ).hexdigest()[:16]
            so = os.path.join(_build_dir(), f"crt_torch_decode_{tag}.so")
            if not os.path.exists(so):
                tmp = so + f".build{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", tmp, "-ljpeg", "-pthread"],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)  # atomic vs concurrent builders
            lib = ctypes.CDLL(so)
            lib.crt_decode_resize.restype = ctypes.c_int
            lib.crt_decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            lib.crt_decode_resize_batch.restype = None
            lib.crt_decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            lib.crt_decode_fast.restype = ctypes.c_int
            lib.crt_decode_fast.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            lib.crt_decode_fast_batch.restype = None
            lib.crt_decode_fast_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            assert lib.crt_abi_version() == 2
            _self_check(lib)
            _lib = lib
        except Exception as e:  # noqa: BLE001 — any failure means "use PIL"
            log.info(f"native decode unavailable ({e}); using PIL")
            _build_failed = True
    return _lib


def _self_check(lib) -> None:
    """Bit-exactness gate at load time: decode+resize one synthetic JPEG
    through the freshly-loaded library and through PIL. Pillow bundles
    libjpeg-turbo while ``-ljpeg`` links the system library — if the host
    has a different libjpeg (e.g. IJG v9, different IDCT arithmetic), the
    'interchangeable mid-dataset' invariant would silently break; instead
    the native path disables itself here."""
    import io

    from PIL import Image

    rng = np.random.RandomState(1234)
    arr = rng.randint(0, 256, (24, 17, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=85)
    data = buf.getvalue()
    ref = np.asarray(
        Image.open(io.BytesIO(data)).convert("RGB").resize(
            (20, 40), Image.BILINEAR
        ),
        np.uint8,
    )
    got = np.empty((40, 20, 3), np.uint8)
    rc = lib.crt_decode_resize(
        data, len(data), 40, 20,
        got.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0 or not np.array_equal(got, ref):
        raise RuntimeError(
            "system libjpeg does not reproduce PIL's decode bytes"
        )


def available() -> bool:
    return _load() is not None


def decode_resize(data: bytes, size_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W, 3], or None (caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    h, w = size_hw
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.crt_decode_resize(
        data, len(data), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if rc == 0 else None


def decode_resize_batch(
    blobs: Sequence[bytes], size_hw: Tuple[int, int],
    out: Optional[np.ndarray] = None, n_threads: int = 0,
) -> Optional[Tuple[np.ndarray, List[int]]]:
    """Decode+resize a batch; returns (out [N,H,W,3], failed_indices) or
    None when the native library is unavailable. ``failed_indices`` lists
    images the caller must decode via PIL."""
    lib = _load()
    if lib is None:
        return None
    h, w = size_hw
    n = len(blobs)
    if out is None:
        out = np.empty((n, h, w, 3), np.uint8)
    # hard checks, not asserts: the C side writes through the raw base
    # pointer assuming a dense [N,H,W,3] uint8 buffer, so a wrong shape /
    # dtype / non-contiguous view would be silent memory corruption
    if (
        out.shape != (n, h, w, 3)
        or out.dtype != np.uint8
        or not out.flags.c_contiguous
    ):
        raise ValueError(
            f"out must be C-contiguous uint8 [{n},{h},{w},3]; got "
            f"{out.shape} {out.dtype} contiguous={out.flags.c_contiguous}"
        )
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    rcs = (ctypes.c_int * n)()
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    lib.crt_decode_resize_batch(
        datas, lens, n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), rcs, n_threads,
    )
    failed = [i for i in range(n) if rcs[i] != 0]
    return out, failed


# ---------------------------------------------------------------------
# Serving-path fast ingest (TPU.FAST_DECODE): DCT-scaled decode + resize
# + planar-YUV420 pack — 1.5 bytes/px on the wire instead of 3. The
# device inverts the packing inside the embed program
# (data/transforms.py::yuv420_to_rgb). NOT bit-exact vs the parity path
# (scaled IDCT + 4:2:0 chroma are lossy); eval keeps decode_resize.
# ---------------------------------------------------------------------

def yuv420_packed_len(size_hw: Tuple[int, int]) -> int:
    h, w = size_hw
    return h * w + 2 * ((h // 2) * (w // 2))


def fast_available(size_hw: Tuple[int, int]) -> bool:
    h, w = size_hw
    return h % 2 == 0 and w % 2 == 0 and _load() is not None


def rgb_to_yuv420_np(img: np.ndarray) -> np.ndarray:
    """Numpy mirror of decode.cpp::rgb_to_yuv420 (bit-exact, same
    fixed-point constants): the host packing wherever the native decoder
    declines or is missing. Works on int32 colour planes; the 2x2 block
    means are four strided adds."""
    h, w, _ = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even dims, got {(h, w)}")
    p = np.moveaxis(img, -1, 0).astype(np.int32)          # [3, H, W]
    r, g, b = p
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    # 2x2 block mean (round-half-up) per channel, then convert
    mr, mg, mb = (p[:, 0::2, 0::2] + p[:, 1::2, 0::2] + p[:, 0::2, 1::2]
                  + p[:, 1::2, 1::2] + 2) >> 2
    u = 128 + ((-11059 * mr - 21709 * mg + 32768 * mb + 32768) >> 16)
    v = 128 + ((32768 * mr - 27440 * mg - 5328 * mb + 32768) >> 16)
    out = np.empty(yuv420_packed_len((h, w)), np.uint8)
    c = (h // 2) * (w // 2)
    out[:h * w] = np.clip(y, 0, 255).ravel()
    out[h * w:h * w + c] = np.clip(u, 0, 255).ravel()
    out[h * w + c:] = np.clip(v, 0, 255).ravel()
    return out


def decode_fast(data: bytes, size_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """JPEG bytes -> packed YUV420 uint8 [1.5*H*W], or None (caller falls
    back to PIL decode + rgb_to_yuv420_np)."""
    lib = _load()
    h, w = size_hw
    if lib is None or h % 2 or w % 2:
        return None
    out = np.empty((yuv420_packed_len(size_hw),), np.uint8)
    rc = lib.crt_decode_fast(
        data, len(data), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if rc == 0 else None


def decode_fast_batch(
    blobs: Sequence[bytes], size_hw: Tuple[int, int],
    out: Optional[np.ndarray] = None, n_threads: int = 0,
) -> Optional[Tuple[np.ndarray, List[int]]]:
    """Batch fast ingest; returns (out [N, 1.5*H*W], failed_indices) or
    None when unavailable. Failed images fall back to the PIL path."""
    lib = _load()
    h, w = size_hw
    if lib is None or h % 2 or w % 2:
        return None
    n = len(blobs)
    plen = yuv420_packed_len(size_hw)
    if out is None:
        out = np.empty((n, plen), np.uint8)
    if (
        out.shape != (n, plen)
        or out.dtype != np.uint8
        or not out.flags.c_contiguous
    ):
        raise ValueError(
            f"out must be C-contiguous uint8 [{n},{plen}]; got "
            f"{out.shape} {out.dtype} contiguous={out.flags.c_contiguous}"
        )
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    rcs = (ctypes.c_int * n)()
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    lib.crt_decode_fast_batch(
        datas, lens, n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), rcs, n_threads,
    )
    failed = [i for i in range(n) if rcs[i] != 0]
    return out, failed
