"""Zstandard frames through the system's ``libzstd`` (``ctypes``).

The orbax checkpoints of the JAX package compress their OCDBT manifests,
B-tree nodes and zarr chunks with zstd. ``libzstd.so.1`` is a system
library of both the machines the port runs on, so the port reads those
frames through it and needs no Python package. A machine without the
library raises ``RuntimeError`` at the first call, naming it.

``decompress`` takes one or more concatenated frames, with or without a
content size in their headers; ``compress`` writes one frame (it serves
the decoder's rate measurement and the tests).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer and ZSTD_outBuffer: {const void* or void* ptr; size_t
    # size; size_t pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise RuntimeError(
            f"zstd frames need the system library libzstd ({name}), which "
            f"this machine lacks: {e}") from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
            ("ZSTD_versionNumber", ctypes.c_uint, []),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
            ("ZSTD_findDecompressedSize", ctypes.c_ulonglong, [vp, size_t]),
            ("ZSTD_createDCtx", vp, []),
            ("ZSTD_freeDCtx", size_t, [vp]),
            ("ZSTD_decompressDCtx", size_t, [vp, vp, size_t, vp, size_t]),
            ("ZSTD_decompressStream", size_t,
             [vp, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]),
            ("ZSTD_DStreamOutSize", size_t, []),
            ("ZSTD_compressBound", size_t, [size_t]),
            ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int])):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    return lib


def version() -> str:
    """The loaded libzstd's version, e.g. ``"1.5.5"``."""
    v = _lib().ZSTD_versionNumber()
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def _address(buf) -> int:
    """The address of a writable buffer's first byte."""
    return ctypes.addressof(ctypes.c_char.from_buffer(buf))


def _source(data):
    """(pointer argument, length) of bytes-like ``data``; ``bytes`` pass
    as they are, other read-only buffers are copied."""
    if isinstance(data, bytes):
        return data, len(data)
    view = memoryview(data).cast("B")
    if view.readonly:
        data = bytes(view)
        return data, len(data)
    return _address(view), len(view)


def decompress(data) -> bytearray:
    """The content of the zstd frame(s) in ``data`` (bytes-like). Raises
    ``ValueError`` on a corrupt, truncated or empty input."""
    lib = _lib()
    src, n = _source(data)
    if n == 0:
        raise ValueError("zstd: no frame in an empty input")
    total = lib.ZSTD_findDecompressedSize(src, n)
    if total == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a sequence of zstd frames")
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        if total != _CONTENTSIZE_UNKNOWN:   # every frame states its size
            out = bytearray(total)
            got = _check(lib, lib.ZSTD_decompressDCtx(
                dctx, _address(out) if total else None, total, src, n),
                "decompress")
            if got != total:
                raise ValueError(f"zstd: {got} bytes decoded, the frames "
                                 f"state {total}")
            return out
        # a frame without a content size: stream into growing output
        out = bytearray()
        step = lib.ZSTD_DStreamOutSize()
        chunk = bytearray(step)
        inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), n, 0)
        left = 1
        while inb.pos < n or left:
            outb = _Buffer(_address(chunk), step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                dctx, ctypes.byref(outb), ctypes.byref(inb)), "stream")
            out += chunk[:outb.pos]
            if inb.pos == n and left and outb.pos == 0:
                raise ValueError("zstd: truncated frame")
        return out
    finally:
        lib.ZSTD_freeDCtx(dctx)


def compress(data, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (bytes-like) at ``level``, with its
    content size in the header."""
    lib = _lib()
    src, n = _source(data)
    cap = lib.ZSTD_compressBound(n)
    out = bytearray(cap)
    got = _check(lib, lib.ZSTD_compress(
        _address(out), cap, src if n else None, n, level), "compress")
    return bytes(out[:got])
