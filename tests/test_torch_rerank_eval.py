"""Windowed k-reciprocal re-ranking on the evaluation path
(``metrics/streaming_eval.py::eval_func_streaming_reranked``, ``R1mAP`` and
the engine's wiring) against the JAX package, whose re-ranker runs its
Pallas selection in interpret mode, and against the reference test's
oracle: the stitched ranking (each query's re-ranked window, then the rest
of the gallery in its stable order) materialised and scored with
``eval_func``.

Tolerances are the reference's ``_assert_same``: mAP, CMC, top-k and each
query's AP within 1e-6, the same query ids."""

import numpy as np
import pytest

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.data.datasets import Record as JRecord
from centroids_reid_tpu.engine import evaluate as jevaluate
from centroids_reid_tpu.metrics import (
    eval_func_streaming_reranked as jax_reranked,
)
from centroids_reid_tpu.metrics import R1mAP as JR1mAP
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data.datasets import Record
from centroids_reid_tpu_torch.engine import evaluate
from centroids_reid_tpu_torch.metrics import (
    R1mAP,
    camid_sets_to_bitmask,
    eval_func,
    eval_func_streaming_reranked,
)
from centroids_reid_tpu_torch.metrics.r1_map import (
    compute_distmat,
    l2_normalize_rows,
)
from centroids_reid_tpu_torch.ops.rerank import rerank_topk

K1, K2, LAM = 6, 3, 0.3


def _random_reid_set(seed, q=15, g=120, d=16, pids=7, cams=4):
    rng = np.random.RandomState(seed)
    qf = rng.randn(q, d).astype(np.float32)
    gf = rng.randn(g, d).astype(np.float32)
    q_pids = rng.randint(0, pids, q)
    g_pids = rng.randint(0, pids, g)
    q_camids = rng.randint(0, cams, q)
    g_camids = rng.randint(0, cams, g)
    q_pids[0] = pids + 5          # a query with no positive
    return qf, gf, q_pids, g_pids, q_camids, g_camids


def _stitched_oracle(qf, gf, q_pids, g_pids, q_camids, g_camids, r,
                     dist="euclidean", respect_camids=False):
    """The stitched ranking materialised: the port's re-ranked window, then
    the stable argsort without the window's rows, scored by eval_func."""
    _, ridx = rerank_topk(qf, gf, r=r, k1=K1, k2=K2, lambda_value=LAM,
                          dist=dist, device="cpu")
    ridx = ridx.numpy()
    orig = np.argsort(compute_distmat(qf, gf, dist, device="cpu"), axis=1,
                      kind="stable")
    stitched = np.stack([
        np.concatenate([ridx[i], orig[i][~np.isin(orig[i], ridx[i])]])
        for i in range(len(qf))])
    return eval_func(stitched, q_pids, g_pids, q_camids, g_camids, 50,
                     respect_camids)


def _assert_same(m1, m2):
    assert m1.mAP == pytest.approx(m2.mAP, abs=1e-6)
    np.testing.assert_allclose(m1.cmc, m2.cmc, atol=1e-6)
    np.testing.assert_allclose(m1.all_topk, m2.all_topk, atol=1e-6)
    np.testing.assert_array_equal(m1.single_performance[:, 0],
                                  m2.single_performance[:, 0])
    np.testing.assert_allclose(m1.single_performance[:, 2],
                               m2.single_performance[:, 2], atol=1e-6)


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("r", [8, 40])
def test_streaming_reranked_matches_jax_and_stitched_oracle(dist, r):
    data = _random_reid_set(0)
    kw = dict(r=r, k1=K1, k2=K2, lambda_value=LAM, dist=dist, g_chunk=32)
    got = eval_func_streaming_reranked(*data, device="cpu", **kw)
    _assert_same(got, jax_reranked(*data, **kw))
    _assert_same(got, _stitched_oracle(*data, r=r, dist=dist))


def test_streaming_reranked_full_window_is_the_rerank_order():
    """r >= G: the whole gallery is the window, so the metrics are those of
    ``rerank_topk``'s order (and the JAX package's)."""
    data = _random_reid_set(1, q=9, g=60)
    qf, gf = data[:2]
    _, ridx = rerank_topk(qf, gf, r=gf.shape[0], k1=K1, k2=K2,
                          lambda_value=LAM, device="cpu")
    kw = dict(r=gf.shape[0] + 25, k1=K1, k2=K2, lambda_value=LAM, g_chunk=16)
    got = eval_func_streaming_reranked(*data, device="cpu", **kw)
    _assert_same(got, eval_func(ridx.numpy(), *data[2:], 50, False))
    _assert_same(got, jax_reranked(*data, **kw))


def test_streaming_reranked_respect_camids_bitmasks():
    """The centroid protocol's removal (bitmask membership, cameras up to
    40) inside and outside the window."""
    rng = np.random.RandomState(2)
    q, g, d = 11, 53, 8
    qf = rng.randn(q, d).astype(np.float32)
    gf = rng.randn(g, d).astype(np.float32)
    q_pids = rng.randint(0, 5, q)
    g_pids = rng.randint(0, 5, g)
    cams = [0, 1, 2, 33, 40]
    q_camids = np.array([cams[i] for i in rng.randint(0, 5, q)])
    g_masks = camid_sets_to_bitmask(
        [rng.choice(cams, rng.randint(1, 4), replace=False)
         for _ in range(g)])
    data = (qf, gf, q_pids, g_pids, q_camids, g_masks)
    kw = dict(r=12, k1=K1, k2=K2, lambda_value=LAM, respect_camids=True,
              g_chunk=16)
    got = eval_func_streaming_reranked(*data, device="cpu", **kw)
    _assert_same(got, jax_reranked(*data, **kw))
    _assert_same(got, _stitched_oracle(*data, r=12, respect_camids=True))


def test_r1map_windowed_rerank_routing():
    """``R1mAP(rerank=True, rerank_window=r)`` evaluates the windowed
    re-ranking (after feat_norm) whatever ``streaming`` says, as the JAX
    package's, and keeps no distance matrix."""
    rng = np.random.RandomState(5)
    n_q, n_g, d = 12, 70, 10
    feats = rng.randn(n_q + n_g, d).astype(np.float32)
    pids = rng.randint(0, 6, n_q + n_g)
    camids = rng.randint(0, 3, n_q + n_g)
    nf = l2_normalize_rows(feats)
    ref = eval_func_streaming_reranked(
        nf[:n_q], nf[n_q:], pids[:n_q], pids[n_q:], camids[:n_q],
        camids[n_q:], r=10, k1=20, k2=6, lambda_value=0.3, device="cpu")
    _assert_same(ref, JR1mAP(n_q, rerank=True, rerank_window=10).compute(
        feats, pids, camids))
    for streaming in (None, False, True):
        ev = R1mAP(n_q, rerank=True, rerank_window=10, streaming=streaming,
                   device="cpu")
        _assert_same(ev.compute(feats, pids, camids), ref)
        with pytest.raises(RuntimeError):
            ev.last_distmat


def _clustered(rng, q_pids, g_pids, dim=16, noise=2.0):
    centers = rng.randn(max(max(q_pids), max(g_pids)) + 1, dim) * 3.0
    qf = np.stack([centers[p] + noise * rng.randn(dim) for p in q_pids])
    gf = np.stack([centers[p] + noise * rng.randn(dim) for p in g_pids])
    return qf.astype(np.float32), gf.astype(np.float32)


def test_compute_reid_metrics_windowed_matches_jax(capsys):
    """``TPU.RERANK`` with ``TPU.RERANK_WINDOW``: the engine's evaluation
    prints the windowed line and equals the JAX package's."""
    rng = np.random.RandomState(2)
    q_pids, g_pids = np.repeat(np.arange(6), 2), np.repeat(np.arange(6), 6)
    qf, gf = _clustered(rng, q_pids, g_pids)
    feats = np.concatenate([qf, gf])
    pids = np.concatenate([q_pids, g_pids])
    camids = np.concatenate([np.zeros(12, int), np.ones(36, int)])
    ms = []
    for make_cfg, module, kw in ((jax_default_cfg, jevaluate, {}),
                                 (get_default_cfg, evaluate,
                                  {"device": "cpu"})):
        cfg = make_cfg()
        cfg.TPU.RERANK = True
        cfg.TPU.RERANK_K1 = 8
        cfg.TPU.RERANK_K2 = 4
        cfg.TPU.RERANK_WINDOW = 15
        ms.append(module.compute_reid_metrics(cfg, feats, pids, camids, 12,
                                              use_centroids=False, **kw))
    _assert_same(ms[1], ms[0])
    out = capsys.readouterr().out
    assert out.count("Windowed re-ranking with k-reciprocal encoding (r=15, "
                     "k1=8, k2=4, lambda=0.3)") == 2


class _FakeDataset:
    def __init__(self, record, query, gallery):
        self.val = [record(f"q{i}", p, c, i)
                    for i, (p, c) in enumerate(query)]
        self.val += [record(f"g{i}", p, c, i)
                     for i, (p, c) in enumerate(gallery)]
        self.num_query = len(query)


@pytest.mark.parametrize("n_gallery", [100, 30_000])
def test_validate_rerank_config_windowed_and_visualize(n_gallery):
    """Windowed re-ranking passes at any size, full re-ranking past the
    guard does not; windowed re-ranking with ``TEST.VISUALIZE yes`` is the
    reference's ValueError, word for word."""
    rng = np.random.RandomState(0)
    query = [(int(p), int(c)) for p, c in
             zip(rng.randint(0, 50, 20), rng.randint(0, 4, 20))]
    gallery = [(int(p), int(c)) for p, c in
               zip(rng.randint(0, 50, n_gallery),
                   rng.randint(0, 4, n_gallery))]
    ds = _FakeDataset(Record, query, gallery)
    jds = _FakeDataset(JRecord, query, gallery)
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.TPU.RERANK = True
        c.TPU.RERANK_WINDOW = 100
    evaluate.validate_rerank_config(cfg, ds)
    jevaluate.validate_rerank_config(jcfg, jds)
    if n_gallery > 1000:
        cfg.TPU.RERANK_WINDOW = 0
        with pytest.raises(ValueError, match="RERANK_WINDOW"):
            evaluate.validate_rerank_config(cfg, ds)
        cfg.TPU.RERANK_WINDOW = 100
    for c in (cfg, jcfg):
        c.TEST.VISUALIZE = "yes"
    with pytest.raises(ValueError, match="VISUALIZE") as port:
        evaluate.validate_rerank_config(cfg, ds)
    with pytest.raises(ValueError) as ref:
        jevaluate.validate_rerank_config(jcfg, jds)
    assert str(port.value) == str(ref.value)
