"""The port's streaming evaluator (metrics/streaming_eval.py) against the
JAX package's ``eval_func_streaming`` and against the port's materialising
``eval_func`` on the stable argsort of the distance matrix, on the CPU.

Tolerances are the reference's ``_assert_same``: mAP, CMC, top-k and each
query's AP within 1e-6, the same query ids. Integer-valued features make
every distance an exact fp32 integer, so both packages and both paths see
the same ties, and the per-hit ranks must be equal outright: a positive
that counted itself would show up as a rank one too high."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu.metrics import eval_func_streaming as jax_streaming
from centroids_reid_tpu.metrics.streaming_eval import (
    _positives_table as jax_positives_table,
    compute_stream_ranks as jax_stream_ranks,
)
from centroids_reid_tpu_torch.metrics import (
    R1mAP,
    camid_sets_to_bitmask,
    compute_stream_ranks,
    eval_func,
    eval_func_streaming,
)
from centroids_reid_tpu_torch.metrics import r1_map
from centroids_reid_tpu_torch.metrics import streaming_eval as S
from centroids_reid_tpu_torch.metrics.r1_map import compute_distmat
from centroids_reid_tpu_torch.ops.stream_rank import order_key


def _random_reid_set(seed, q=23, g=157, d=16, pids=9, cams=4):
    rng = np.random.RandomState(seed)
    qf = rng.randn(q, d).astype(np.float32)
    gf = rng.randn(g, d).astype(np.float32)
    q_pids = rng.randint(0, pids, q)
    g_pids = rng.randint(0, pids, g)
    q_camids = rng.randint(0, cams, q)
    g_camids = rng.randint(0, cams, g)
    q_pids[0] = pids + 5          # a query with no positive
    return qf, gf, q_pids, g_pids, q_camids, g_camids


def _materialised(qf, gf, q_pids, g_pids, q_camids, g_camids, dist,
                  respect_camids=False, max_rank=50):
    distmat = torch.from_numpy(compute_distmat(qf, gf, dist, device="cpu"))
    indices = torch.argsort(distmat, dim=1, stable=True)
    return eval_func(indices, q_pids, g_pids, q_camids, g_camids, max_rank,
                     respect_camids)


def _assert_same(m1, m2):
    assert m1.mAP == pytest.approx(m2.mAP, abs=1e-6)
    np.testing.assert_allclose(m1.cmc, m2.cmc, atol=1e-6)
    np.testing.assert_allclose(m1.all_topk, m2.all_topk, atol=1e-6)
    np.testing.assert_array_equal(m1.single_performance[:, 0],
                                  m2.single_performance[:, 0])
    np.testing.assert_allclose(m1.single_performance[:, 2],
                               m2.single_performance[:, 2], atol=1e-6)


def _both(data, **kw):
    """The port's streaming metrics, the JAX package's, and the port's
    materialising ones on ``data``."""
    g_chunk = kw.pop("g_chunk", S._G_CHUNK)
    dist = kw.get("dist", "euclidean")
    respect = kw.get("respect_camids", False)
    got = eval_func_streaming(*data, g_chunk=g_chunk, device="cpu", **kw)
    ref = jax_streaming(*data, g_chunk=g_chunk, **kw)
    mat = _materialised(*data, dist, respect_camids=respect)
    return got, ref, mat


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("g_chunk", [32, S._G_CHUNK])
def test_streaming_matches_jax_and_argsort(dist, g_chunk):
    """g_chunk 32 cuts 157 rows into 5 tiles, the last one ragged."""
    got, ref, mat = _both(_random_reid_set(0), dist=dist, g_chunk=g_chunk)
    _assert_same(got, ref)
    _assert_same(got, mat)


def test_streaming_ranks_equal_jax_on_exact_ties():
    """Integer features with three duplicated gallery rows of one pid:
    every distance is exact, ties are everywhere, and the per-hit ranks
    (no positive counting itself) equal the JAX package's and the ranks
    read off the stable argsort."""
    qf, gf, q_pids, g_pids, q_camids, g_camids = _random_reid_set(1, g=96)
    rng = np.random.RandomState(1)
    qf = rng.randint(-2, 3, qf.shape).astype(np.float32)
    gf = rng.randint(-2, 3, gf.shape).astype(np.float32)
    gf[10] = gf[40] = gf[77]
    g_pids[10] = g_pids[40] = g_pids[77]
    data = (qf, gf, q_pids, g_pids, q_camids, g_camids)
    got = compute_stream_ranks(*data, g_chunk=32, device="cpu")
    ref = jax_stream_ranks(*data, g_chunk=32)
    np.testing.assert_array_equal(got.pos, ref.pos)
    np.testing.assert_array_equal(got.ranks, ref.ranks)
    np.testing.assert_array_equal(got.dpos, ref.dpos)
    # each hit's rank among the kept entries of the stable argsort
    distmat = compute_distmat(qf, gf, "euclidean", device="cpu")
    order = np.argsort(distmat, axis=1, kind="stable")
    for q in range(len(qf)):
        keep = ~((g_pids[order[q]] == q_pids[q])
                 & (g_camids[order[q]] == q_camids[q]))
        rank_of = np.cumsum(keep) - 1
        where = np.argsort(order[q])
        for h, j in enumerate(got.pos[q]):
            if j >= 0:
                assert got.ranks[q, h] == rank_of[where[j]], (q, h, j)
    m, r, mat = _both(data, g_chunk=32)
    _assert_same(m, r)
    _assert_same(m, mat)


def test_streaming_respect_camids_bitmasks():
    rng = np.random.RandomState(2)
    q, g, d = 17, 61, 8
    qf = rng.randn(q, d).astype(np.float32)
    gf = rng.randn(g, d).astype(np.float32)
    q_pids = rng.randint(0, 6, q)
    g_pids = rng.randint(0, 6, g)
    q_camids = rng.randint(0, 4, q)
    g_masks = camid_sets_to_bitmask(
        [rng.choice(4, rng.randint(1, 4), replace=False) for _ in range(g)])
    got, ref, mat = _both((qf, gf, q_pids, g_pids, q_camids, g_masks),
                          respect_camids=True, g_chunk=16)
    _assert_same(got, ref)
    _assert_same(got, mat)


def test_streaming_respect_camids_high_camera_ids():
    """Cameras 31 to 62 test their own bit of the one int64 mask word (the
    reference's high int32 word)."""
    rng = np.random.RandomState(7)
    q, g, d = 13, 47, 8
    cams = [0, 5, 30, 31, 40, 62]
    qf = rng.randn(q, d).astype(np.float32)
    gf = rng.randn(g, d).astype(np.float32)
    q_pids = rng.randint(0, 5, q)
    g_pids = rng.randint(0, 5, g)
    q_camids = np.array([cams[i] for i in rng.randint(0, len(cams), q)])
    g_masks = camid_sets_to_bitmask(
        [rng.choice(cams, rng.randint(1, 4), replace=False)
         for _ in range(g)])
    got, ref, mat = _both((qf, gf, q_pids, g_pids, q_camids, g_masks),
                          respect_camids=True, g_chunk=16)
    assert got.mAP < 1.0
    _assert_same(got, ref)
    _assert_same(got, mat)


def test_streaming_pid_heavy_gallery_multiple_h_tiles():
    """One pid holds 3 * _H_CHUNK + 17 rows, so the positives axis spans
    at least three compare tiles; ties inside the heavy pid."""
    rng = np.random.RandomState(11)
    q, d = 9, 8
    heavy = 3 * S._H_CHUNK + 17
    qf = rng.randn(q, d).astype(np.float32)
    g_pids = np.concatenate([np.zeros(heavy, np.int64),
                             rng.randint(1, 5, 40)])
    g = len(g_pids)
    gf = rng.randn(g, d).astype(np.float32)
    gf[5] = gf[60] = gf[100]
    q_pids = np.array([0] * 6 + [1, 2, 9])
    q_camids = rng.randint(0, 3, q)
    g_camids = rng.randint(0, 3, g)
    data = (qf, gf, q_pids, g_pids, q_camids, g_camids)
    sr = compute_stream_ranks(*data, g_chunk=64, device="cpu")
    assert sr.pos.shape[1] >= 3 * S._H_CHUNK
    got, ref, mat = _both(data, g_chunk=64)
    _assert_same(got, ref)
    _assert_same(got, mat)


def test_streaming_accepts_list_and_tensor_galleries():
    """A list of rows and a tensor (which stays where it is) give the
    array's metrics."""
    qf, gf, q_pids, g_pids, q_camids, g_camids = _random_reid_set(11)
    rest = (q_pids, g_pids, q_camids, g_camids)
    m_arr = eval_func_streaming(qf, gf, *rest, device="cpu")
    _assert_same(m_arr, eval_func_streaming(qf, [row for row in gf], *rest,
                                            device="cpu"))
    _assert_same(m_arr, eval_func_streaming(torch.from_numpy(qf),
                                            torch.from_numpy(gf), *rest))


def _labels(seed, q=29, g=211, pids=9, cams=6):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, pids, q), rng.randint(0, pids, g),
            rng.randint(0, cams, q), rng.randint(0, cams, g))


def _bitmask_labels():
    """Query cameras 0-62 against random int64 masks over bits 0-62."""
    rng = np.random.RandomState(21)
    q_pids, g_pids, _, _ = _labels(21)
    return (q_pids, g_pids, rng.randint(0, 63, len(q_pids)),
            rng.randint(0, np.iinfo(np.int64).max, len(g_pids),
                        dtype=np.int64))


def _pid_heavy_labels():
    """One pid holds 3 * _H_CHUNK + 40 rows, spread through the gallery,
    so a query of it has hits in three tiles or more."""
    rng = np.random.RandomState(22)
    g_pids = rng.randint(1, 6, 3 * S._H_CHUNK + 120)
    g_pids[rng.permutation(len(g_pids))[:3 * S._H_CHUNK + 40]] = 0
    q_pids = np.array([0, 0, 3, 0, 5, 1, 0])
    return (q_pids, g_pids, rng.randint(0, 3, len(q_pids)),
            rng.randint(0, 3, len(g_pids)))


def _pid_heavy_bitmask_labels():
    """The pid-heavy gallery, each row's mask one bit of cameras 0-2."""
    q_pids, g_pids, q_cams, _ = _pid_heavy_labels()
    rng = np.random.RandomState(26)
    return q_pids, g_pids, q_cams, 1 << rng.randint(0, 3, len(g_pids))


def _absent_labels():
    q_pids, g_pids, q_cams, g_cams = _labels(23)
    q_pids[::3] = 40 + np.arange(len(q_pids[::3]))
    return q_pids, g_pids, q_cams, g_cams


def _junk_labels():
    """Junk (-1) and distractor (0) gallery rows, and queries of pid 0."""
    q_pids, g_pids, q_cams, g_cams = _labels(24)
    g_pids[::4] = -1
    g_pids[1::5] = 0
    q_pids[:3] = 0
    return q_pids, g_pids, q_cams, g_cams


def _no_hit_labels():
    q_pids, g_pids, q_cams, g_cams = _labels(25)
    return q_pids + 100, g_pids, q_cams, g_cams


def _empty_query_labels():
    q_pids, g_pids, q_cams, g_cams = _labels(27)
    return q_pids[:0], g_pids, q_cams[:0], g_cams


_TABLE_CASES = {
    "plain_cameras": (lambda: _labels(20), False),
    "respect_camids_bitmasks": (_bitmask_labels, True),
    "pid_heavy": (_pid_heavy_labels, False),
    "pid_heavy_bitmasks": (_pid_heavy_bitmask_labels, True),
    "absent_query_pids": (_absent_labels, False),
    "junk_and_distractors": (_junk_labels, False),
    "no_query_has_a_hit": (_no_hit_labels, False),
    "empty_query_set": (_empty_query_labels, False),
    "lists": (lambda: tuple(x.tolist() for x in _labels(28)), False),
    "int32_arrays": (
        lambda: tuple(x.astype(np.int32) for x in _labels(29)), False),
}


def _same_table(labels, respect):
    got = S._positives_table(*labels, respect)
    ref = jax_positives_table(*labels, respect)
    assert got.dtype == ref.dtype == np.int32
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("case", sorted(_TABLE_CASES))
def test_positives_table_equals_jax(case):
    """The vectorised table equals the JAX package's loop: values, shape
    and dtype."""
    make, respect = _TABLE_CASES[case]
    got = _same_table(make(), respect)
    assert got.shape[1] % S._H_CHUNK == 0
    if case.startswith("pid_heavy"):
        assert (got >= 0).sum(axis=1).max() > 2 * S._H_CHUNK
    if case == "no_query_has_a_hit":
        assert got.shape[1] == S._H_CHUNK and (got == -1).all()
    if case == "empty_query_set":
        assert got.shape == (0, S._H_CHUNK)


def test_positives_table_at_the_cell_layout():
    """market-r50-eval500k's labels: 3,368 queries, 15,913 gallery rows
    over 750 ids, then 500,000 distractors of one pid, 6 cameras."""
    rng = np.random.RandomState(30)
    nq, ng, ids, distractors = 3368, 15913, 750, 500_000
    q_pids = rng.randint(0, ids, nq)
    g_pids = np.concatenate([rng.randint(0, ids, ng),
                             np.full(distractors, ids)])
    labels = (q_pids, g_pids, rng.randint(0, 6, nq),
              rng.randint(0, 6, ng + distractors))
    got = _same_table(labels, False)
    assert got.shape == (nq, S._H_CHUNK) and (got >= 0).any()


@pytest.mark.parametrize("values", [
    [0.0, -0.0, 1.5, -1.5, 3e-45, -3e-45, 2.0, 2.0, -7.25, float("inf")],
])
def test_order_key_is_lexicographic(values):
    """``order_key`` (the count's keys, ``ops/stream_rank.py``) orders
    (d, j) as the reference's float comparisons: d first (-0.0 equal to
    +0.0), then j."""
    d = torch.tensor(values, dtype=torch.float32)
    j = torch.arange(len(values)) * 7 % len(values)
    key = order_key(d, j)
    for a in range(len(values)):
        for b in range(len(values)):
            before = (d[a] < d[b]) | ((d[a] == d[b]) & (j[a] < j[b]))
            assert bool(key[a] < key[b]) == bool(before), (a, b)


def test_r1map_switches_to_streaming_past_the_cell_count(monkeypatch):
    """``streaming=None`` streams past ``_STREAMING_CELLS`` (lowered here):
    the same metrics, and no distance matrix afterwards; under the count it
    materialises."""
    rng = np.random.RandomState(3)
    n_q, n_g, d = 19, 83, 12
    feats = rng.randn(n_q + n_g, d).astype(np.float32)
    pids = rng.randint(0, 7, n_q + n_g)
    camids = rng.randint(0, 3, n_q + n_g)
    ev = R1mAP(n_q, device="cpu")
    m_mat = ev.compute(feats, pids, camids)
    assert ev.last_distmat.shape == (n_q, n_g)
    calls = []
    real = r1_map.eval_func_streaming
    monkeypatch.setattr(r1_map, "eval_func_streaming",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(r1_map, "_STREAMING_CELLS", n_q * n_g - 1)
    m_str = ev.compute(feats, pids, camids)
    assert calls == [1]
    _assert_same(m_str, m_mat)
    with pytest.raises(RuntimeError, match="streaming"):
        ev.last_distmat
    forced = R1mAP(n_q, streaming=True, device="cpu")
    _assert_same(forced.compute(torch.from_numpy(feats), pids, camids),
                 m_mat)


def test_streaming_refuses_a_mesh():
    """A mesh is no longer refused: on three CPU shards (the 20 rows
    padded to 3 x 8, one shard all padding) the passes give the unsharded
    ranks and distances bit for bit."""
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    data = _random_reid_set(4, q=5, g=20)
    mesh = make_retrieval_mesh(devices=["cpu"] * 3)
    got = compute_stream_ranks(*data, g_chunk=8, mesh=mesh)
    ref = compute_stream_ranks(*data, g_chunk=8, device="cpu")
    np.testing.assert_array_equal(got.ranks, ref.ranks)
    np.testing.assert_array_equal(got.dpos, ref.dpos)
    _assert_same(eval_func_streaming(*data, g_chunk=8, mesh=mesh),
                 eval_func_streaming(*data, g_chunk=8, device="cpu"))
