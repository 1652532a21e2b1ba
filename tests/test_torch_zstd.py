"""The port's zstd frames (``utils/zstd.py``, the system's libzstd through
ctypes) against frames written by the ``zstandard`` package: levels 1, 3
and 19, with and without a content size in the header, written in one call
or streamed, empty, one block and many (zstd blocks hold at most 128 KB),
concatenated frames; truncated or corrupt input raises ``ValueError``, a
machine without libzstd raises ``RuntimeError`` naming it. Outputs are
compared byte for byte."""

import numpy as np
import pytest
import zstandard

from centroids_reid_tpu_torch.utils import zstd

_RNG = np.random.RandomState(0)
# fp32 weights (compress little) then runs of one byte (compress a lot):
# 1.5 MB, a dozen zstd blocks
_DATA = (_RNG.randn(300_000).astype(np.float32).tobytes()
         + bytes(range(256)) * 1000 + b"\0" * 100_000)
_SMALL = b"orbax" * 7


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("data", [_DATA, _SMALL, b""],
                         ids=["multi-block", "one-block", "empty"])
def test_frames_of_zstandard_decode(level, content_size, data):
    frame = zstandard.ZstdCompressor(
        level=level, write_content_size=content_size).compress(data)
    assert bytes(zstd.decompress(frame)) == data
    # the same frame in every buffer type the reader hands over
    assert bytes(zstd.decompress(bytearray(frame))) == data
    assert bytes(zstd.decompress(memoryview(frame))) == data


@pytest.mark.parametrize("level", [1, 19])
def test_streamed_frames_decode(level):
    """A frame written in pieces, without a content size."""
    cobj = zstandard.ZstdCompressor(level=level).compressobj()
    frame = b"".join(cobj.compress(_DATA[i:i + 65_536])
                     for i in range(0, len(_DATA), 65_536)) + cobj.flush()
    assert bytes(zstd.decompress(frame)) == _DATA


def test_concatenated_frames_decode():
    sized = zstandard.ZstdCompressor().compress(_SMALL)
    unsized = zstandard.ZstdCompressor(write_content_size=False).compress(
        _DATA)
    assert bytes(zstd.decompress(sized + sized)) == _SMALL * 2
    assert bytes(zstd.decompress(sized + unsized)) == _SMALL + _DATA


def test_compress_round_trips_and_zstandard_reads_it():
    frame = zstd.compress(_DATA, level=1)
    assert zstandard.ZstdDecompressor().decompress(frame) == _DATA
    assert bytes(zstd.decompress(frame)) == _DATA
    assert bytes(zstd.decompress(zstd.compress(b""))) == b""


@pytest.mark.parametrize("content_size", [True, False])
def test_bad_input_raises(content_size):
    frame = zstandard.ZstdCompressor(
        write_content_size=content_size).compress(_DATA)
    with pytest.raises(ValueError):
        zstd.decompress(frame[:len(frame) // 2])
    with pytest.raises(ValueError):
        zstd.decompress(b"")
    with pytest.raises(ValueError):
        zstd.decompress(b"not a zstd frame at all")


def test_missing_library_raises_naming_it(monkeypatch):
    import ctypes.util

    monkeypatch.setattr(ctypes.util, "find_library",
                        lambda name: "libzstd-absent.so.0")
    zstd._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libzstd"):
            zstd.decompress(b"\x28\xb5\x2f\xfd")
    finally:
        monkeypatch.undo()
        zstd._lib.cache_clear()
    assert zstd.version().count(".") == 2   # the real library again
