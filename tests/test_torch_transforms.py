"""The port's serving transforms (centroids_reid_tpu_torch/data/
transforms.py) against the JAX package's: decode is bit-exact (the same
native decoder or PIL), normalisation equal to fp32 rounding."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.data import transforms as JT
from centroids_reid_tpu_torch.data import transforms as TT


def _blobs():
    rng = np.random.RandomState(0)
    out = []
    for fmt in ("JPEG", "PNG"):
        for _ in range(2):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (70, 40, 3), np.uint8)).save(
                buf, fmt)
            out.append(buf.getvalue())
    return out


def test_ingest_blobs_matches_jax():
    blobs = _blobs()
    got = TT.ingest_blobs("rgb", (64, 32), blobs)
    np.testing.assert_array_equal(got, JT.ingest_blobs("rgb", (64, 32), blobs))
    assert got.shape == (4, 64, 32, 3) and got.dtype == np.uint8
    with pytest.raises(NotImplementedError, match="FAST_DECODE"):
        TT.ingest_blobs("yuv420", (64, 32), blobs)


def test_decode_without_any_decoder_raises(monkeypatch):
    from centroids_reid_tpu import native

    monkeypatch.setattr(native, "decode_resize", lambda data, size: None)
    monkeypatch.setattr(TT, "_pil", lambda: None)
    with pytest.raises(RuntimeError, match="no image decoder"):
        TT.decode_and_resize_bytes(_blobs()[0], (64, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_batch_matches_jax(dtype):
    imgs = np.random.RandomState(1).randint(0, 256, (3, 8, 4, 3), np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = JT.normalize_batch(jnp.asarray(imgs), mean, std,
                             dtype=getattr(jnp, dtype))
    got = TT.normalize_batch(torch.from_numpy(imgs), mean, std,
                             dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-6,
                               atol=1e-6)
