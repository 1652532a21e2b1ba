"""Sharded streaming evaluation: the port's ``compute_stream_ranks``,
``eval_func_streaming``, ``eval_func_streaming_reranked`` and ``R1mAP``
with ``mesh`` (8 CPU shards) against the JAX package's on its 8-device
virtual CPU mesh, and against the port's unsharded passes (the checks of
tests/test_streaming_eval.py:146-210 and tests/test_rerank_eval.py:158).

Tolerances are the reference's ``_assert_same``: mAP, CMC, top-k and each
query's AP within 1e-6, the same query ids. Against the port's unsharded
passes the per-hit ranks and distances are equal bit for bit: each shard
computes the tiles the unsharded pass computes."""

import numpy as np
import pytest

from centroids_reid_tpu.metrics import R1mAP as JR1mAP
from centroids_reid_tpu.metrics import camid_sets_to_bitmask as jax_bitmask
from centroids_reid_tpu.metrics import eval_func_streaming as jax_streaming
from centroids_reid_tpu.metrics import (
    eval_func_streaming_reranked as jax_reranked,
)
from centroids_reid_tpu.parallel import make_retrieval_mesh as jax_mesh
from centroids_reid_tpu_torch.metrics import (
    R1mAP,
    camid_sets_to_bitmask,
    compute_stream_ranks,
    eval_func_streaming,
    eval_func_streaming_reranked,
)
from centroids_reid_tpu_torch.metrics import streaming_eval as S
from centroids_reid_tpu_torch.parallel import make_retrieval_mesh
from test_torch_streaming_eval import _assert_same, _random_reid_set

K1, K2, LAM = 6, 3, 0.3


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(8), make_retrieval_mesh(devices=["cpu"] * 8)


def _same_ranks(data, mesh, g_chunk, **kw):
    got = compute_stream_ranks(*data, g_chunk=g_chunk, mesh=mesh, **kw)
    ref = compute_stream_ranks(*data, g_chunk=g_chunk, device="cpu", **kw)
    np.testing.assert_array_equal(got.pos, ref.pos)
    np.testing.assert_array_equal(got.ranks, ref.ranks)
    np.testing.assert_array_equal(got.dpos, ref.dpos)


def test_sharded_streaming_matches_jax(meshes):
    """G = 210 over 8 shards of 2 tiles of 16: the last shards hold only
    padding."""
    jm, mesh = meshes
    data = _random_reid_set(4, q=11, g=210)
    got = eval_func_streaming(*data, g_chunk=16, mesh=mesh)
    _assert_same(got, jax_streaming(*data, g_chunk=16, mesh=jm))
    _assert_same(got, eval_func_streaming(*data, g_chunk=16, device="cpu"))
    _same_ranks(data, mesh, 16)


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_sharded_streaming_respect_camids(meshes, dist):
    """The centroid protocol (bitmask camids, membership removal) with the
    extraction summed over shards before any shard counts."""
    jm, mesh = meshes
    rng = np.random.RandomState(5)
    q, g, d = 13, 190, 8
    qf = rng.randn(q, d).astype(np.float32)
    gf = rng.randn(g, d).astype(np.float32)
    q_pids = rng.randint(0, 6, q)
    g_pids = rng.randint(0, 6, g)
    q_camids = rng.randint(0, 4, q)
    cam_sets = [rng.choice(4, rng.randint(1, 4), replace=False)
                for _ in range(g)]
    kw = dict(respect_camids=True, dist=dist, g_chunk=16)
    got = eval_func_streaming(qf, gf, q_pids, g_pids, q_camids,
                              camid_sets_to_bitmask(cam_sets), mesh=mesh,
                              **kw)
    ref = jax_streaming(qf, gf, q_pids, g_pids, q_camids,
                        jax_bitmask(cam_sets), mesh=jm, **kw)
    _assert_same(got, ref)
    _same_ranks((qf, gf, q_pids, g_pids, q_camids,
                 camid_sets_to_bitmask(cam_sets)), mesh, 16,
                respect_camids=True, dist=dist)


def test_sharded_streaming_pid_heavy(meshes):
    """H spans several positives tiles; the shards' extractions of one
    hit's distance meet before counting."""
    jm, mesh = meshes
    rng = np.random.RandomState(12)
    q, d = 5, 8
    heavy = 2 * S._H_CHUNK + 9
    g_pids = np.concatenate([np.zeros(heavy, np.int64),
                             rng.randint(1, 4, 31)])
    g = len(g_pids)
    data = (rng.randn(q, d).astype(np.float32),
            rng.randn(g, d).astype(np.float32), np.array([0, 0, 0, 1, 7]),
            g_pids, rng.randint(0, 3, q), rng.randint(0, 3, g))
    _assert_same(eval_func_streaming(*data, g_chunk=16, mesh=mesh),
                 jax_streaming(*data, g_chunk=16, mesh=jm))
    _same_ranks(data, mesh, 16)


def test_sharded_streaming_reranked_matches_jax(meshes):
    """``mesh`` shards both the rank counting and the windows' selection
    (``rerank_topk(mesh=)``)."""
    jm, mesh = meshes
    data = _random_reid_set(4, q=9, g=208)
    kw = dict(r=16, k1=K1, k2=K2, lambda_value=LAM, g_chunk=16)
    got = eval_func_streaming_reranked(*data, mesh=mesh, **kw)
    _assert_same(got, jax_reranked(*data, mesh=jm, **kw))
    _assert_same(got, eval_func_streaming_reranked(*data, device="cpu",
                                                   **kw))


@pytest.mark.parametrize("rerank_window", [0, 10])
def test_sharded_r1map_matches_jax(meshes, rerank_window):
    """``R1mAP(mesh=)``: feat_norm first, then the sharded streaming
    evaluation, plain or windowed re-ranked."""
    jm, mesh = meshes
    rng = np.random.RandomState(6)
    feats = rng.randn(90, 12).astype(np.float32)
    pids = rng.randint(0, 8, 90)
    camids = rng.randint(0, 3, 90)
    kw = dict(streaming=True, rerank=bool(rerank_window),
              rerank_window=rerank_window, rerank_k1=K1, rerank_k2=K2)
    got = R1mAP(15, mesh=mesh, **kw).compute(feats, pids, camids)
    ref = JR1mAP(15, mesh=jm, **kw).compute(feats, pids, camids)
    _assert_same(got, ref)
    assert R1mAP(15, mesh=mesh).device.type == "cpu"
