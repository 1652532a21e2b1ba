"""int8 serving: the port's RetrievalService with the int8 gallery index
(K4 + the hierarchical top-k on K3) and the int8 PTQ embed (K5 / K6 plain
versions on the CPU) against the JAX package's service, on the weights,
gallery and queries of test_torch_service.py. Tolerances as there: indices
equal, distances rtol 1e-4, atol 1e-4 (exact fp32 re-scores of the same
rows); both int8 embeds run one artifact with int32 accumulators."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.models import quantized as JQ
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.models import quantized as TQ
from test_torch_service import _serve_both, slice_setup  # noqa: F401



@pytest.mark.parametrize("k,exact", [(5, True), (40, True), (5, False)])
def test_int8_gallery_service_matches_jax(slice_setup, monkeypatch, k,
                                          exact):
    """use_int8_gallery=True on the fp32 embed: K4 + the hierarchical top-k
    select default_margin(k) candidates, re-scored against the fp32 rows
    (exact) or their dequantized codes (capacity mode, no fp32 copy)."""
    svc, d, _ = _serve_both(slice_setup, monkeypatch, k=k,
                            use_int8_gallery=True, exact_rescore=exact)
    assert svc._int8_sel == k + 16 and svc._gf.codes.dtype == torch.int8
    assert (svc._gf32 is None) == (not exact)
    assert (np.diff(d, axis=1) >= 0).all()


@pytest.fixture(scope="module")
def int8_artifact(slice_setup, tmp_path_factory):
    """One int8 artifact (int32 accumulators, unfused engine) in both
    packages, calibrated on 8 of the gallery images."""
    cfg, bundle, _, _, _, _ = slice_setup
    rng = np.random.RandomState(0)
    calib = rng.randint(0, 256, (48, 64, 32, 3)).astype(np.uint8)[:8]
    jq = JQ.quantize_reid_model(*bundle, [calib], cfg.INPUT.PIXEL_MEAN,
                                cfg.INPUT.PIXEL_STD, acc_dtype=jnp.int32)
    path = str(tmp_path_factory.mktemp("int8") / "q.npz")
    jq.save(path)
    return jq, TQ.QuantizedEmbed.load(path)


@pytest.mark.parametrize("gallery", ["int8", "int8_capacity", "bf16"])
def test_int8_embed_service_matches_jax(slice_setup, monkeypatch,
                                        int8_artifact, gallery):
    """int8_qfn: the PTQ embed takes the uint8 batch, then L2; each gallery
    image still finds its own fp32-embedded row first. With the int8
    gallery this is the whole int8 serving path."""
    jq, tq = int8_artifact
    kw = dict(k=5, int8_qfn=tq, jax_int8_qfn=jq)
    if gallery != "bf16":
        kw.update(use_int8_gallery=True,
                  exact_rescore=gallery == "int8")
    svc, _, _ = _serve_both(slice_setup, monkeypatch, **kw)
    assert svc.ingest_format == "rgb"


def test_int8_calib_imgs_builds_the_reference_default_embed(slice_setup):
    """int8_calib_imgs calibrates the service's own model with the
    reference's defaults (unfused engine, bf16 accumulators,
    TPU.INT8_CALIB_PCT) and answers as an int8_qfn built that way."""
    cfg, _, port, emb, paths, queries = slice_setup
    calib = queries[:4]
    svc = RetrievalService(cfg, emb, paths, k=5, device="cpu", model=port,
                           int8_calib_imgs=calib, use_int8_gallery=True)
    assert svc._qfn._use_pallas is False
    assert svc._qfn._acc_dtype == torch.bfloat16
    qfn = TQ.quantize_reid_model(port, [calib], cfg.INPUT.PIXEL_MEAN,
                                 cfg.INPUT.PIXEL_STD,
                                 calib_percentile=cfg.TPU.INT8_CALIB_PCT)
    twin = RetrievalService(cfg, emb, paths, k=5, device="cpu", model=port,
                            int8_qfn=qfn, use_int8_gallery=True)
    for a, b in zip(svc.query_arrays(queries), twin.query_arrays(queries)):
        np.testing.assert_array_equal(a, b)
    assert (svc.query_arrays(queries)[1][:4, 0] == [3, 17, 30, 47]).all()


def test_int8_gallery_clamps_query_batch_and_margin(slice_setup):
    """The int8 gallery always materialises [B, Gp] scores, so
    max_query_batch is clamped at every k; the margin is clamped to the
    real row count."""
    from centroids_reid_tpu_torch.ops.retrieval import _SCORE_BUDGET_BYTES

    cfg, _, port, emb, paths, _ = slice_setup
    svc = RetrievalService(cfg, emb, paths, k=5, device="cpu", model=port,
                           use_int8_gallery=True, max_query_batch=1 << 20)
    assert svc.max_query_batch == _SCORE_BUDGET_BYTES // (1024 * 4) // 128 * 128
    wide = RetrievalService(cfg, emb[:30], paths[:30], k=20, device="cpu",
                            model=port, use_int8_gallery=True)
    assert wide._int8_sel == 30
