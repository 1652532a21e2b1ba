"""The port's serving and eval transforms (centroids_reid_tpu_torch/data/
transforms.py, its copy of the native decoder, native/) against the JAX
package's: decode is bit-exact (the same native decoder source or PIL),
normalisation equal to fp32 rounding; and the port's copy of the config
tree equals the JAX package's, key for key."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.data import transforms as JT
from centroids_reid_tpu_torch.data import transforms as TT

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


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
    packed = TT.ingest_blobs("yuv420", (64, 32), blobs)
    np.testing.assert_array_equal(
        packed, JT.ingest_blobs("yuv420", (64, 32), blobs))
    assert packed.shape == (4, 64 * 32 * 3 // 2) and packed.dtype == np.uint8


def test_decode_without_any_decoder_raises(monkeypatch):
    from centroids_reid_tpu_torch import native

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


def test_load_and_resize_matches_jax(tmp_path):
    for i, blob in enumerate(_blobs()):
        path = tmp_path / f"img{i}"
        path.write_bytes(blob)
        np.testing.assert_array_equal(
            TT.load_and_resize(str(path), (64, 32)),
            JT.load_and_resize(str(path), (64, 32)))


def test_native_copy_decodes_as_the_jax_package_and_builds_its_own_library():
    """The port's native decoder decodes a JPEG batch to the JAX package's
    bytes, and its cached library has a name of its own."""
    from centroids_reid_tpu import native as jnative
    from centroids_reid_tpu_torch import native

    jpegs = _blobs()[:2]
    if not native.available():
        pytest.skip("native decoder not buildable here (g++ / libjpeg)")
    got, failed = native.decode_resize_batch(jpegs, (64, 32))
    ref, jfailed = jnative.decode_resize_batch(jpegs, (64, 32))
    assert failed == jfailed == []
    np.testing.assert_array_equal(got, ref)
    own = {f for f in os.listdir(native._build_dir())
           if f.startswith("crt_torch_decode_")}
    assert own and native._lib._name.rsplit("/", 1)[-1] in own


@pytest.mark.parametrize("yml", ["", "256_resnet50.yml",
                                 "320_resnet50_ibn_a.yml"])
def test_config_copy_matches_jax(yml):
    """The same defaults, the same YAML files and the same opts merge to
    the same tree, less the port's transformer keys (the JAX package has no
    transformer), which keep TransReID's own defaults, and Swin's
    ``SEMANTIC_WEIGHT``."""
    from centroids_reid_tpu.config import get_default_cfg as jcfg
    from centroids_reid_tpu_torch.config import get_default_cfg

    opts = ["MODEL.NAME", "resnet18", "TPU.INT8_EVAL", "True",
            "INPUT.SIZE_TEST", "[64,32]"]
    got, ref = get_default_cfg(), jcfg()
    for cfg in (got, ref):
        if yml:
            cfg.merge_from_file(os.path.join(_CONFIGS, yml))
        cfg.merge_from_list(opts)
    for section, key in _TRANSREID_KEYS:
        assert got[section].pop(key) == _TRANSREID_KEYS[section, key], key
    assert got == ref and got.dump() == ref.dump()


# the port's transformer keys and their defaults (TransReID config/
# defaults.py; SEMANTIC_WEIGHT, read by Swin alone, the port's)
_TRANSREID_KEYS = {
    ("MODEL", "TRANSFORMER_TYPE"): "None", ("MODEL", "STRIDE_SIZE"): [16, 16],
    ("MODEL", "SIE_CAMERA"): False, ("MODEL", "SIE_COE"): 3.0,
    ("MODEL", "JPM"): False, ("MODEL", "RE_ARRANGE"): True,
    ("MODEL", "SHIFT_NUM"): 5, ("MODEL", "SHUFFLE_GROUP"): 2,
    ("MODEL", "DEVIDE_LENGTH"): 4, ("TEST", "NECK_FEAT"): "after",
    ("MODEL", "SEMANTIC_WEIGHT"): 1.0}
