"""The port's eval metrics (centroids_reid_tpu_torch/metrics/,
losses/distances.py) against the JAX package's on the same numpy inputs,
on the CPU.

Tolerances: CMC and top-k are ratios of integer counts, so they must be
equal; mAP sums fp32 precisions in another order (1e-6); centroid means
and distances differ only by fp32 summation order (1e-6 absolute for the
means, rtol 1e-5 for the distances). Integer-valued features make every
distance an exact fp32 integer, so R1mAP's ranking (a stable argsort in
both packages) is exact."""

import numpy as np
import pytest

from centroids_reid_tpu.metrics import centroids as JC
from centroids_reid_tpu.metrics import eval_reid as JE
from centroids_reid_tpu.metrics import r1_map as JR
from centroids_reid_tpu_torch.metrics import centroids as TC
from centroids_reid_tpu_torch.metrics import eval_reid as TE
from centroids_reid_tpu_torch.metrics import r1_map as TR


def _eval_inputs(respect: bool):
    """20 queries over 60 gallery entries of 8 pids; in camera-aware mode
    the gallery camids are bitmasks with bits up to 40 and two queries sit
    on cameras >= 32, so the high word of the reference's split is used."""
    rng = np.random.RandomState(0)
    q_pids = rng.randint(0, 8, 20)
    g_pids = rng.randint(0, 8, 60)
    indices = np.stack([rng.permutation(60) for _ in range(20)])
    if respect:
        q_camids = rng.randint(0, 6, 20)
        q_camids[:2] = [33, 40]
        g_camids = np.zeros(60, np.int64)
        for i in range(60):
            for c in rng.choice([0, 1, 2, 3, 4, 5, 31, 33, 40], 3):
                g_camids[i] |= 1 << int(c)
    else:
        q_camids = rng.randint(0, 6, 20)
        g_camids = rng.randint(0, 6, 60)
    return indices, q_pids, g_pids, q_camids, g_camids


def _assert_metrics_equal(got, ref):
    np.testing.assert_array_equal(got.cmc, ref.cmc)
    np.testing.assert_array_equal(got.all_topk, ref.all_topk)
    assert abs(got.mAP - ref.mAP) <= 1e-6
    np.testing.assert_allclose(got.single_performance,
                               ref.single_performance, rtol=0, atol=1e-6)


@pytest.mark.parametrize("respect", [False, True])
def test_eval_func_matches_jax(respect):
    args = _eval_inputs(respect)
    ref = JE.eval_func(*args, max_rank=50, respect_camids=respect)
    got = TE.eval_func(*args, max_rank=50, respect_camids=respect)
    assert ref.mAP < 1.0 and len(ref.single_performance) > 10
    _assert_metrics_equal(got, ref)


def test_camid_sets_to_bitmask_matches_jax():
    sets = [[0, 1], [5], [31, 33], [], [2, 62]]
    np.testing.assert_array_equal(TE.camid_sets_to_bitmask(sets),
                                  JE.camid_sets_to_bitmask(sets))


def _embedding_set(rng, nq=12, ng=40, d=16):
    emb = rng.randn(nq + ng, d).astype(np.float32)
    labels = np.concatenate([rng.randint(0, 6, nq), rng.randint(0, 8, ng)])
    camids = np.concatenate([rng.randint(0, 4, nq), rng.randint(0, 4, ng)])
    return emb, labels, camids, nq


@pytest.mark.parametrize("respect", [False, True])
def test_build_centroid_eval_set_matches_jax(respect):
    """Sorted-pid order, the camera-combination dedup and the dropping of
    gallery pids with no query (pids 6 and 7 have none)."""
    emb, labels, camids, nq = _embedding_set(np.random.RandomState(1))
    ref = JC.build_centroid_eval_set(emb, labels, camids, nq, respect)
    got = TC.build_centroid_eval_set(emb, labels, camids, nq, respect)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.camids, ref.camids)
    assert got.respect_camids == ref.respect_camids
    np.testing.assert_allclose(got.embeddings, ref.embeddings, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_compute_distmat_matches_jax(dist):
    rng = np.random.RandomState(2)
    qf = rng.randn(17, 32).astype(np.float32)
    gf = rng.randn(70, 32).astype(np.float32)
    ref = JR.compute_distmat(qf, gf, dist)
    got = TR.compute_distmat(qf, gf, dist, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("respect", [False, True])
def test_r1map_compute_matches_jax(respect):
    """Integer features (exact distances with many ties), through the
    centroid construction in both modes, then R1mAP."""
    rng = np.random.RandomState(3)
    emb, labels, camids, nq = _embedding_set(rng, nq=16, ng=60, d=8)
    emb = np.round(emb * 1.5)
    es = JC.build_centroid_eval_set(emb, labels, camids, nq, respect)
    ref = JR.R1mAP(nq, feat_norm=False).compute(
        es.embeddings, es.labels, es.camids, respect_camids=respect)
    got = TR.R1mAP(nq, feat_norm=False, device="cpu").compute(
        es.embeddings, es.labels, es.camids, respect_camids=respect)
    _assert_metrics_equal(got, ref)
    plain_ref = JR.R1mAP(nq, feat_norm=False).compute(emb, labels, camids)
    plain = TR.R1mAP(nq, feat_norm=False, device="cpu").compute(
        emb, labels, camids)
    _assert_metrics_equal(plain, plain_ref)


@pytest.mark.parametrize("kwargs", [
    {"streaming": True}, {"streaming": True, "mesh": 8},
    # windowed re-ranked evaluation runs on the streaming evaluator
    {"rerank": True, "rerank_window": 5},
    {"rerank": True, "rerank_window": 5, "mesh": 8}])
def test_r1map_refuses_unported_options(kwargs):
    """Nothing is refused: ``streaming=True``, windowed re-ranked
    evaluation and ``mesh`` (``"mesh": n`` is the JAX package's n-device
    CPU mesh and the port's mesh of n CPU shards) evaluate as the JAX
    package's R1mAP with the same options."""
    from centroids_reid_tpu.parallel import make_retrieval_mesh as jax_mesh
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    rng = np.random.RandomState(4)
    feats = rng.randn(30, 8).astype(np.float32)
    pids = rng.randint(0, 5, 30)
    camids = rng.randint(0, 3, 30)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if "mesh" in kwargs:
        jkw["mesh"] = jax_mesh(kwargs["mesh"])
        tkw["mesh"] = make_retrieval_mesh(devices=["cpu"] * kwargs["mesh"])
    ref = JR.R1mAP(6, **jkw).compute(feats, pids, camids)
    got = TR.R1mAP(6, device="cpu", **tkw).compute(feats, pids, camids)
    _assert_metrics_equal(got, ref)


def _clustered(rng, pids_q, pids_g, dim=16, noise=2.0):
    centers = rng.randn(max(max(pids_q), max(pids_g)) + 1, dim) * 3.0
    qf = np.stack([centers[p] + noise * rng.randn(dim) for p in pids_q])
    gf = np.stack([centers[p] + noise * rng.randn(dim) for p in pids_g])
    return qf.astype(np.float32), gf.astype(np.float32)


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_r1map_rerank_matches_jax(dist):
    """R1mAP(rerank=True) scores the fully re-ranked distance matrix: CMC,
    Top-k and mAP (within 1e-6) as the JAX package's, and the metrics
    differ from the unranked ones on these overlapping clusters."""
    rng = np.random.RandomState(2)
    q_pids, g_pids = np.repeat(np.arange(6), 2), np.repeat(np.arange(6), 6)
    qf, gf = _clustered(rng, q_pids, g_pids)
    feats = np.concatenate([qf, gf])
    pids = np.concatenate([q_pids, g_pids])
    camids = np.concatenate([np.zeros(12, int), np.ones(36, int)])
    kw = dict(feat_norm=True, dist_name=dist, rerank=True, rerank_k1=8,
              rerank_k2=4, rerank_lambda=0.3)
    ref = JR.R1mAP(12, **kw).compute(feats, pids, camids)
    ev = TR.R1mAP(12, device="cpu", **kw)
    got = ev.compute(feats, pids, camids)
    _assert_metrics_equal(got, ref)
    assert ev.last_distmat.shape == (12, 36)
    plain = TR.R1mAP(12, feat_norm=True, dist_name=dist,
                     device="cpu").compute(feats, pids, camids)
    assert plain.mAP != got.mAP


def test_r1map_rerank_refuses_the_streaming_evaluator():
    """Full re-ranking with ``streaming=True`` is the reference's
    ValueError."""
    with pytest.raises(ValueError, match="streaming"):
        TR.R1mAP(4, rerank=True, streaming=True, device="cpu")
