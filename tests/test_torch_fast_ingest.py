"""The fast serving ingest (``TPU.FAST_DECODE``: packed planar YUV420, 1.5
bytes a pixel) against the JAX package on the CPU: the host packing, the
unpack (``yuv420_to_rgb``, ``normalize_yuv420_batch``), the yuv420
``ImageStore``, ``run_inference`` and a service answering packed queries
(resnet18, 32x16 JPEGs, fp32, one reference-format ``.pth``).

Tolerances: the packing is integer work on the same decoder, so bytes are
equal. The unpack's chroma upsample is exact in fp32 on 8-bit input (the
port's bilinear resample and the reference's separable filter give the
same bits); the BT.601 products round in fp32 and XLA may fuse them (1e-4
on [0, 255], 1e-5 after normalisation). ``run_inference`` on the fast
path returns its embeddings rounded to bf16, as the reference does, so two
fp32 values 1e-6 apart may round to neighbouring bf16 values: within one
bf16 step (2^-7 relative). The service's distances are exact fp32
re-scores of fp32 embeddings: rtol 1e-4, atol 1e-4, as
``test_torch_service.py``."""

import functools
import io

import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.data import loader as jloader
from centroids_reid_tpu.data import transforms as JT
from centroids_reid_tpu.inference import api as japi
from centroids_reid_tpu.inference import service as jservice
from centroids_reid_tpu.inference import utils as jutils
from centroids_reid_tpu.ops.retrieval import topk_select as jax_topk_select
from centroids_reid_tpu_torch import native
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data import loader as tloader
from centroids_reid_tpu_torch.data import transforms as TT
from centroids_reid_tpu_torch.inference import (
    RetrievalService,
    load_inference_model,
)
from centroids_reid_tpu_torch.inference import utils as tutils
from test_torch_eval import write_reference_pth

HW = (32, 16)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _packed(n, seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    return np.stack([native.rgb_to_yuv420_np(i) for i in imgs])


def _jpegs(n, seed=0, hw=(40, 20)):
    """Smooth-ish JPEGs of another size than HW (the resize runs)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = rng.randint(30, 226, (1, 1, 3))
        img = base + rng.randint(-25, 26, (*hw, 3))
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("hw", [(32, 16), (256, 128), (6, 2)])
def test_rgb_to_yuv420_np_matches_jax(hw):
    """The port's host packing (int32 planes, strided block sums) equals
    the JAX package's copy byte for byte, the extremes included."""
    from centroids_reid_tpu import native as jnative

    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
            np.zeros((*hw, 3), np.uint8), np.full((*hw, 3), 255, np.uint8)]
    for img in imgs:
        np.testing.assert_array_equal(native.rgb_to_yuv420_np(img),
                                      jnative.rgb_to_yuv420_np(img))
    with pytest.raises(ValueError, match="even"):
        native.rgb_to_yuv420_np(np.zeros((5, 4, 3), np.uint8))


@pytest.mark.parametrize("hw", [(32, 16), (256, 128), (6, 4)])
def test_yuv420_to_rgb_matches_jax(hw):
    packed = _packed(3, seed=1, hw=hw)
    ref = np.asarray(JT.yuv420_to_rgb(packed, hw))
    got = TT.yuv420_to_rgb(torch.from_numpy(packed), hw).numpy()
    assert got.shape == (3, *hw, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert got.min() >= 0.0 and got.max() <= 255.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_yuv420_batch_matches_jax(dtype):
    import jax.numpy as jnp

    packed = _packed(4, seed=2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(JT.normalize_yuv420_batch(packed, HW, MEAN, STD,
                                               dtype=jdt), np.float32)
    got = TT.normalize_yuv420_batch(torch.from_numpy(packed), HW, MEAN, STD,
                                    dtype=dtype)
    assert got.dtype == dtype and got.shape == (4, *HW, 3)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * 3
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("native_decoder", [True, False])
def test_decode_and_pack_matches_jax(monkeypatch, native_decoder):
    """The native DCT-scaled decode + pack, and without it (both packages'
    fallback) PIL's decode and resize packed on the host: equal bytes."""
    from centroids_reid_tpu import native as jnative

    if not native_decoder:
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "decode_fast", lambda data, hw: None)
    blobs = _jpegs(3)
    for b in blobs:
        got = TT.decode_and_pack_yuv420_bytes(b, HW)
        np.testing.assert_array_equal(
            got, JT.decode_and_pack_yuv420_bytes(b, HW))
        assert got.shape == (HW[0] * HW[1] * 3 // 2,)


def test_yuv420_image_store_matches_jax(tmp_path):
    paths = []
    for i, b in enumerate(_jpegs(5, seed=3)):
        p = tmp_path / f"img{i}.jpg"
        p.write_bytes(b)
        paths.append(str(p))
    store = tloader.ImageStore(HW, cache=True, fmt="yuv420")
    ref = jloader.ImageStore(HW, cache=True, fmt="yuv420")
    assert store.item_shape() == ref.item_shape() == (768,)
    out = np.zeros((5, 768), np.uint8)
    store.get_many(paths, out)
    want = np.stack([ref.get(p) for p in paths])
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(store.get(paths[2]), want[2])
    with pytest.raises(ValueError, match="even"):
        tloader.ImageStore((31, 16), fmt="yuv420")


def _cfg(make_cfg, pth, fast):
    cfg = make_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = list(HW)
    cfg.TEST.IMS_PER_BATCH = 4
    cfg.MODEL.PRETRAIN_PATH = pth
    cfg.TPU.FAST_DECODE = fast
    return cfg


@pytest.mark.parametrize("fast,int8,size,native_decoder,want", [
    (False, False, HW, True, "rgb"),
    (True, False, HW, True, "yuv420"),
    (True, True, HW, True, "rgb"),
    (True, False, (31, 16), True, "rgb"),
    (True, False, HW, False, "rgb"),
])
def test_serving_ingest_format_matches_jax(monkeypatch, fast, int8, size,
                                           native_decoder, want):
    """``TPU.FAST_DECODE`` selects packed YUV420 where the reference does:
    not for an int8 embed, an odd ``SIZE_TEST`` or a missing native
    decoder (the exact RGB path serves there)."""
    from centroids_reid_tpu import native as jnative

    if not native_decoder:
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_load", lambda: None)
    cfgs = []
    for make_cfg in (get_default_cfg, jax_default_cfg):
        cfg = _cfg(make_cfg, "", fast)
        cfg.TPU.INT8_EVAL = int8
        cfg.INPUT.SIZE_TEST = list(size)
        cfgs.append(cfg)
    assert tutils.serving_ingest_format(cfgs[0]) == want
    assert jutils.serving_ingest_format(cfgs[1]) == want


@pytest.fixture(scope="module")
def ingest_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fast_ingest")
    pth = write_reference_pth(tmp / "reid.pth", seed=3)
    paths = []
    for i, b in enumerate(_jpegs(6, seed=4)):
        p = tmp / f"img{i}.jpg"
        p.write_bytes(b)
        paths.append(str(p))
    jcfg = _cfg(jax_default_cfg, pth, True)
    bundle = japi.load_inference_model(jcfg)
    port = load_inference_model(_cfg(get_default_cfg, pth, True), "cpu")
    return pth, paths, bundle, port


def test_run_inference_fast_decode_matches_jax(ingest_setup):
    """``TPU.FAST_DECODE``: the packed batches, unpacked in the embed,
    give the JAX package's embeddings (each within one bf16 step) and
    stay close to the RGB path (cosine > 0.995, the reference's check);
    a yuv420 store feeding a custom embed is refused."""
    pth, paths, (jmodel, params, stats), port = ingest_setup
    cfg = _cfg(get_default_cfg, pth, True)
    assert tutils.serving_ingest_format(cfg) == "yuv420"
    got, got_paths = tutils.run_inference(port, cfg, paths)
    ref, _ = jutils.run_inference(jmodel, _cfg(jax_default_cfg, pth, True),
                                  params, stats, paths)
    assert got.dtype == np.float32 and got.shape == (6, 512)
    np.testing.assert_array_equal(got_paths, paths)
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
    rgb, _ = tutils.run_inference(port, _cfg(get_default_cfg, pth, False),
                                  paths)
    cos = (got * rgb).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(rgb, axis=1))
    assert cos.min() > 0.995, cos
    store = tloader.ImageStore(HW, fmt="yuv420")
    with pytest.raises(ValueError, match="yuv420 store"):
        tutils.run_inference(port, cfg, paths, embed_fn=lambda x: x,
                             store=store)


def test_service_packed_queries_match_jax(ingest_setup, monkeypatch):
    """A FAST_DECODE service: ``ingest_bytes`` packs, and ``query_arrays``
    on the packed batch answers as the JAX service on the same packed
    batch and weights (its Pallas selection in interpret mode); each
    gallery image's top-1 is its own row."""
    pth, paths, bundle, port = ingest_setup
    monkeypatch.setattr(jservice, "topk_select",
                        functools.partial(jax_topk_select, interpret=True))
    blobs = [open(p, "rb").read() for p in paths]
    cfg = _cfg(get_default_cfg, pth, True)
    emb, _ = tutils.run_inference(port, cfg, paths)
    rng = np.random.RandomState(5)
    gallery = np.concatenate([emb, rng.randn(100, 512).astype(np.float32)])
    names = np.array([f"g{i:03d}" for i in range(len(gallery))])
    svc = RetrievalService(cfg, gallery, names, k=5, device="cpu",
                           model=port)
    ref = jservice.RetrievalService(_cfg(jax_default_cfg, pth, True),
                                    gallery, names, k=5, model_bundle=bundle)
    assert svc.ingest_format == ref.ingest_format == "yuv420"
    packed = svc.ingest_bytes(blobs)
    np.testing.assert_array_equal(packed, ref.ingest_bytes(blobs))
    assert packed.shape == (6, 768)
    d, i, p = svc.query_arrays(packed)
    rd, ri, rp = ref.query_arrays(packed)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_allclose(d, rd, rtol=1e-4, atol=1e-4)
    assert (i[:, 0] == np.arange(6)).all()
    db, ib, _ = svc.query_bytes(blobs)
    np.testing.assert_array_equal(ib, i)
    np.testing.assert_array_equal(db, d)
