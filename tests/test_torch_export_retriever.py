"""Retriever artifacts: the port's ``export_retriever`` / ``load_retriever``
against the JAX package's on the same weights, gallery and queries
(resnet18, 32x16, fp32; 40 gallery rows, k = 5, batch 4), plain,
re-ranked at load (``rerank_window``, euclidean and cosine) and on the
yuv420 ingest, and against the port's live ``RetrievalService``.

Tolerances as in test_torch_export.py: indices equal; distances rtol 1e-4,
atol 1e-4 against JAX (the packages' fp32 conv order), within 1e-6 against
the live service (identical expected). The JAX retrievers select in exact
fp32 without Pallas (``use_pallas=False``), the port's on the CPU's exact
fp32 gallery."""

import io
import json
import struct

import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.inference import export as jexport
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.inference import export as X
from test_torch_export import HW, TOL, imgs, models, small_cfg  # noqa: F401

RERANK = dict(rerank_k1=6, rerank_k2=3, rerank_lambda=0.3)


def _jax_with_distance(src, dst, distance):
    """A copy of a JAX retriever artifact whose meta names another
    SOLVER.DISTANCE_FUNC (the program does not depend on it)."""
    blob, meta, aux = jexport._read_artifact_sections(src)
    jexport.save_artifact(dst, blob, {**meta, "distance": distance}, aux=aux)
    return dst


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """Each package's k = 5 retriever (batch 4) and a copy of each naming
    the cosine distance."""
    (model, params, stats), port, gallery, paths = models
    tmp = tmp_path_factory.mktemp("retrievers")
    blob, meta, aux = jexport.export_retriever(
        model, small_cfg(jax_default_cfg), params, stats, gallery, paths,
        k=5, batch_size=4, platforms=("cpu",))
    out = {"jax_retriever": str(tmp / "jax_retriever.crtpu")}
    jexport.save_artifact(out["jax_retriever"], blob, meta, aux=aux)
    out["jax_retriever_cos"] = _jax_with_distance(
        out["jax_retriever"], str(tmp / "jax_retriever_cos.crtpu"), "cosine")
    blobs, meta, aux = X.export_retriever(port, small_cfg(get_default_cfg),
                                          gallery, paths, k=5, batch_size=4,
                                          platforms=("cpu",))
    out["retriever"] = str(tmp / "retriever.crt")
    X.save_artifact(out["retriever"], blobs, meta, aux=aux)
    _, meta = X.read_artifact(out["retriever"])
    out["retriever_cos"] = str(tmp / "retriever_cos.crt")
    X.save_artifact(out["retriever_cos"], blobs,
                    {**meta, "distance": "cosine"}, aux=aux)
    return out


def _live_service(models, **kw):
    _, port, gallery, paths = models
    cfg = small_cfg(get_default_cfg, **kw.pop("cfg", {}))
    return RetrievalService(cfg, gallery, paths, k=5, use_bf16_kernel=False,
                            device="cpu", model=port, **kw)


def _queries():
    """7 images: a batch of the retriever's 4 and a partial one of 3."""
    return imgs(7, 30)


def test_retriever_matches_jax_and_live(models, artifacts):
    ret = X.load_retriever(artifacts["retriever"], "cpu")
    assert ret.k == 5 and ret.meta["gallery_size"] == 40
    assert ret.ingest_format == "rgb" and ret.meta["rank_stage"] == "live"
    assert ret._gf.dtype == torch.float32   # exact fp32 selection on the CPU
    assert list(ret.paths) == list(models[3])
    q = _queries()
    d, i, p = ret.query_arrays(q)
    jd, ji, jp = jexport.load_retriever(
        artifacts["jax_retriever"], use_bf16_kernel=False,
        use_pallas=False).query_arrays(q)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(d, jd, **TOL)
    svc = _live_service(models)
    for rows in (slice(0, 4), slice(4, 7)):
        sd, si, _ = svc.query_arrays(q[rows])
        np.testing.assert_array_equal(i[rows], si)
        np.testing.assert_allclose(d[rows], sd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_reranked_retriever_matches_jax_and_live(models, artifacts,
                                                 distance):
    """``rerank_window`` at load: the export-time distance is the re-rank's
    local distance."""
    suffix = "_cos" if distance == "cosine" else ""
    ret = X.load_retriever(artifacts["retriever" + suffix], "cpu",
                           rerank_window=20, **RERANK)
    assert ret.rerank_window == 20 and ret._dist == distance
    q = _queries()
    d, i, _ = ret.query_arrays(q)
    jd, ji, _ = jexport.load_retriever(
        artifacts["jax_retriever" + suffix], use_bf16_kernel=False,
        use_pallas=False, rerank_window=20, **RERANK).query_arrays(q)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, **TOL)
    svc = _live_service(models, rerank_window=20,
                        cfg={"SOLVER.DISTANCE_FUNC": distance}, **RERANK)
    sd, si, _ = svc.query_arrays(q[:4])
    np.testing.assert_array_equal(i[:4], si)
    np.testing.assert_allclose(d[:4], sd, rtol=0, atol=1e-6)


def test_rerank_refuses_unnormalised_cosine_artifact(models, artifacts,
                                                     tmp_path):
    blobs, meta = X.read_artifact(artifacts["retriever_cos"])
    _, _, aux = X._read_artifact_sections(artifacts["retriever_cos"])
    path = str(tmp_path / "raw_cos.crt")
    X.save_artifact(path, blobs, {**meta, "normalized": False}, aux=aux)
    with pytest.raises(ValueError, match="normalize=True"):
        X.load_retriever(path, "cpu", rerank_window=20)
    assert X.load_retriever(path, "cpu").rerank_window == 0


def test_yuv420_retriever_matches_jax_and_live(models, tmp_path):
    """``TPU.FAST_DECODE``: the retriever takes packed YUV420 rows."""
    (model, params, stats), port, gallery, paths = models
    jcfg = small_cfg(jax_default_cfg, **{"TPU.FAST_DECODE": True})
    cfg = small_cfg(get_default_cfg, **{"TPU.FAST_DECODE": True})
    blob, meta, aux = jexport.export_retriever(
        model, jcfg, params, stats, gallery, paths, k=5, batch_size=4,
        platforms=("cpu",))
    jpath = str(tmp_path / "jax_yuv.crtpu")
    jexport.save_artifact(jpath, blob, meta, aux=aux)
    blobs, meta, aux = X.export_retriever(port, cfg, gallery, paths, k=5,
                                          batch_size=4, platforms=("cpu",))
    assert meta["ingest"] == "yuv420"
    assert meta["distance"] == cfg.SOLVER.DISTANCE_FUNC
    path = str(tmp_path / "yuv.crt")
    X.save_artifact(path, blobs, meta, aux=aux)
    ret = X.load_retriever(path, "cpu")
    q = np.random.RandomState(40).randint(
        0, 256, (6, HW[0] * HW[1] * 3 // 2), np.uint8)
    d, i, _ = ret.query_arrays(q)
    jd, ji, _ = jexport.load_retriever(
        jpath, use_bf16_kernel=False, use_pallas=False).query_arrays(q)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, **TOL)
    svc = _live_service(models, cfg={"TPU.FAST_DECODE": True})
    assert svc.ingest_format == "yuv420"
    sd, si, _ = svc.query_arrays(q[:4])
    np.testing.assert_array_equal(i[:4], si)
    np.testing.assert_allclose(d[:4], sd, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="expected uint8"):
        ret.query_arrays(imgs(2, 41))


def test_artifact_layout(artifacts):
    """MAGIC | meta_len (8 B LE) | meta JSON | aux | programs, with one
    program per device type and its length in the meta."""
    with open(artifacts["retriever"], "rb") as f:
        raw = f.read()
    assert raw[:10] == X.MAGIC
    (n,) = struct.unpack("<Q", raw[10:18])
    meta = json.loads(raw[18:18 + n])
    assert meta["format_version"] == X.FORMAT_VERSION_AUX
    assert meta["platforms"] == ["cpu"] and meta["kind"] == "retriever"
    assert "torch_version" in meta and "jax_version" not in meta
    aux = raw[18 + n:18 + n + meta["aux_bytes"]]
    with np.load(io.BytesIO(aux), allow_pickle=True) as z:
        assert z["gallery"].shape == (40, 512)
        np.testing.assert_allclose(np.linalg.norm(z["gallery"], axis=1), 1.0,
                                   rtol=1e-6)
    assert len(raw) == 18 + n + meta["aux_bytes"] + sum(meta["blob_bytes"])


def test_retriever_artifact_validation(artifacts, tmp_path):
    with pytest.raises(ValueError, match="StableHLO artifact of the JAX"):
        X.load_retriever(artifacts["jax_retriever"], "cpu")
    with pytest.raises(ValueError, match="kind"):
        X.load_embedder(artifacts["retriever"], "cpu")
    blobs, meta = X.read_artifact(artifacts["retriever"])
    _, _, aux = X._read_artifact_sections(artifacts["retriever"])
    no_aux = str(tmp_path / "no_aux.crt")
    X.save_artifact(no_aux, blobs, {k: v for k, v in meta.items()
                                    if k != "aux_bytes"})
    with pytest.raises(ValueError, match="no gallery aux"):
        X.load_retriever(no_aux, "cpu")
    no_rank = str(tmp_path / "no_rank.crt")
    X.save_artifact(no_rank, blobs, {k: v for k, v in meta.items()
                                     if k != "rank_stage"}, aux=aux)
    with pytest.raises(ValueError, match="re-export"):
        X.load_retriever(no_rank, "cpu")
    with pytest.raises(ValueError, match="no program for device type 'cuda'"):
        X.load_retriever(artifacts["retriever"], "cuda")
    with pytest.raises(ValueError, match="fixed batch_size"):
        X.export_retriever(None, small_cfg(get_default_cfg), np.ones((2, 4)),
                           ["a", "b"], batch_size=None, platforms=("cpu",))


def test_retriever_warmup_and_num_compiles(artifacts):
    ret = X.load_retriever(artifacts["retriever"], "cpu")
    ret.warmup()
    assert ret.num_compiles == 1
    ret.query_arrays(imgs(3, 53))            # pads to the batch of 4
    assert ret.num_compiles == 1
    d, i, p = ret.query_arrays(imgs(0, 54))
    assert d.shape == i.shape == p.shape == (0, 5)
