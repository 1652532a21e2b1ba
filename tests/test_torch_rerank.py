"""k-reciprocal re-ranking: the port's ``rerank_distmat`` and
``rerank_topk`` against the JAX package's and against the loop oracle
``np_oracle.oracle_rerank``, on seeded numpy inputs on the CPU. The JAX
``rerank_topk`` selects its window through ``topk_retrieval`` in interpret
mode.

Tolerances: values within 1e-5 (fp32 distances, exp and sums in another
order). Indices equal wherever the sorted values differ by more than
1e-5; within a run of values closer than that (at lambda 0 several
windows' Jaccard distances are equal in exact arithmetic, and fp32
rounding orders them in each package its own way) the same set of
indices. Among the exact ties of duplicated gallery rows (integer
features, so every distance is exact) indices are equal outright."""

import functools

import numpy as np
import pytest
import torch

from centroids_reid_tpu.ops import rerank as J
from centroids_reid_tpu.ops import retrieval as JR
from centroids_reid_tpu_torch.ops import rerank as T
from centroids_reid_tpu_torch.ops import rerank_distmat, rerank_topk
from np_oracle import oracle_rerank

ATOL = 1e-5


@pytest.fixture()
def jax_interpret(monkeypatch):
    monkeypatch.setattr(JR, "topk_retrieval",
                        functools.partial(JR.topk_retrieval, interpret=True))


def _feats(seed, q=12, g=40, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(q, d).astype(np.float32),
            rng.randn(g, d).astype(np.float32))


def assert_same_ranking(vals, idx, ref_idx):
    """Per row of ascending ``vals``: ``idx`` equals ``ref_idx`` at every
    position, up to order within runs of values closer than ATOL."""
    vals, idx, ref_idx = (np.asarray(a) for a in (vals, idx, ref_idx))
    assert idx.shape == ref_idx.shape
    for v, i, ri in zip(vals, idx, ref_idx):
        cuts = np.nonzero(np.diff(v) > ATOL)[0] + 1
        for a, b in zip(np.split(i, cuts), np.split(ri, cuts)):
            assert sorted(a) == sorted(b), (v, i, ri)


def _dense(qf, gf, *args, **kw):
    return rerank_distmat(qf, gf, *args, device="cpu", **kw).numpy()


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("k1,k2", [(8, 4), (6, 1)])
def test_rerank_distmat_matches_jax_and_oracle(dist, lam, k1, k2):
    qf, gf = _feats(0)
    got = _dense(qf, gf, k1, k2, lam, dist)
    ref = np.asarray(J.rerank_distmat(qf, gf, k1, k2, lam, dist))
    assert got.shape == (12, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle_rerank(qf, gf, k1, k2, lam, dist),
                               rtol=0, atol=ATOL)
    order = np.argsort(got, 1, kind="stable")
    assert_same_ranking(np.take_along_axis(got, order, 1), order,
                        np.argsort(ref, 1, kind="stable"))


def test_rerank_distmat_lambda_one_is_the_normalised_original_order():
    qf, gf = _feats(1, q=9, g=31, d=12)
    got = _dense(qf, gf, 6, 3, 1.0)
    f = np.concatenate([qf, gf])
    sq = (f * f).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * f @ f.T).astype(np.float32)
    dn = d / np.maximum(d.max(axis=1, keepdims=True), 1e-12)
    np.testing.assert_allclose(got, dn[:9, 9:], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(np.argsort(got, 1, kind="stable"),
                                  np.argsort(d[:9, 9:], 1, kind="stable"))


@pytest.mark.parametrize("q,g,k1,k2", [(3, 5, 20, 9), (1, 9, 3, 2)])
def test_rerank_distmat_clamps(q, g, k1, k2):
    """k1 beyond N - 1 and k2 beyond k1 + 1 clamp as in the reference; a
    single query works."""
    qf, gf = _feats(2, q=q, g=g, d=4)
    got = _dense(qf, gf, k1, k2)
    np.testing.assert_allclose(got, np.asarray(J.rerank_distmat(qf, gf, k1,
                                                                k2)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle_rerank(qf, gf, k1, k2), rtol=0,
                               atol=ATOL)


def test_rerank_distmat_guard_and_empty_inputs():
    qf, gf = _feats(3, q=4, g=8, d=4)
    with pytest.raises(ValueError, match="max_n=10") as port:
        rerank_distmat(qf, gf, max_n=10, device="cpu")
    with pytest.raises(ValueError) as ref:
        J.rerank_distmat(qf, gf, max_n=10)
    assert str(port.value) == str(ref.value)
    assert _dense(np.zeros((0, 4)), gf).shape == (0, 8)
    assert _dense(qf, np.zeros((0, 4))).shape == (4, 0)


def _duplicated(seed):
    """Integer features with every second gallery row a copy of an earlier
    one, and two queries equal to gallery rows: exact ties everywhere."""
    rng = np.random.RandomState(seed)
    base = rng.randint(-3, 4, (20, 16)).astype(np.float32)
    gf = np.concatenate([base, base[::2]])
    qf = np.concatenate([rng.randint(-3, 4, (4, 16)).astype(np.float32),
                         base[[5, 6]]])
    return qf, gf


def test_rerank_distmat_duplicated_rows_tie_as_jax():
    qf, gf = _duplicated(4)
    got = _dense(qf, gf, 6, 3)
    ref = np.asarray(J.rerank_distmat(qf, gf, 6, 3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    order = np.argsort(got, 1, kind="stable")
    np.testing.assert_array_equal(order, np.argsort(ref, 1, kind="stable"))
    # the copies of a row score alike, so both are in the ranking's ties
    np.testing.assert_array_equal(got[:, 20:], got[:, 0:20:2])


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("r,k1,k2,lam", [(10, 5, 2, 0.3), (40, 20, 6, 0.3),
                                         (8, 4, 1, 0.0), (15, 6, 3, 1.0)])
def test_rerank_topk_matches_jax(jax_interpret, dist, r, k1, k2, lam):
    qf, gf = _feats(5)
    d, i = rerank_topk(qf, gf, r=r, k1=k1, k2=k2, lambda_value=lam,
                       dist=dist, device="cpu")
    rd, ri = J.rerank_topk(qf, gf, r=r, k1=k1, k2=k2, lambda_value=lam,
                           dist=dist)
    assert d.shape == i.shape == (12, r) and i.dtype == torch.int64
    assert_same_ranking(d, i, ri)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=ATOL)


def test_rerank_topk_is_the_dense_reranker_of_each_window():
    """Each query re-ranked against its own top-r window: the oracle of
    that query and window, and ``rerank_distmat`` of it."""
    qf, gf = _feats(6, q=6, g=40, d=12)
    r, k1, k2, lam = 10, 5, 2, 0.3
    d, i = rerank_topk(qf, gf, r=r, k1=k1, k2=k2, lambda_value=lam,
                       device="cpu")
    sq = (gf * gf).sum(1)[None, :] - 2.0 * qf @ gf.T
    for q in range(len(qf)):
        window = np.argsort(sq[q], kind="stable")[:r]
        vals = oracle_rerank(qf[q:q + 1], gf[window], k1, k2, lam)[0]
        order = np.argsort(vals, kind="stable")
        np.testing.assert_array_equal(i[q].numpy(), window[order])
        np.testing.assert_allclose(d[q].numpy(), vals[order], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(
            d[q].numpy(),
            _dense(qf[q:q + 1], gf[window], k1, k2, lam)[0][order], rtol=0,
            atol=ATOL)


def test_rerank_topk_duplicated_rows_tie_as_jax(jax_interpret):
    qf, gf = _duplicated(7)
    d, i = rerank_topk(qf, gf, r=20, k1=6, k2=3, device="cpu")
    rd, ri = J.rerank_topk(qf, gf, r=20, k1=6, k2=3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=ATOL)


def test_rerank_topk_clamps_chunks_and_empty(jax_interpret):
    """r beyond G clamps to G, k1 and k2 beyond the window clamp; chunking
    the queries changes nothing; empty inputs give empty results."""
    qf, gf = _feats(8, q=3, g=5, d=8)
    d, i = rerank_topk(qf, gf, r=50, k1=30, k2=20, device="cpu")
    rd, ri = J.rerank_topk(qf, gf, r=50, k1=30, k2=20)
    assert d.shape == i.shape == (3, 5) and sorted(i[0].tolist()) == [0, 1, 2,
                                                                      3, 4]
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=ATOL)
    qf, gf = _feats(9)
    whole = rerank_topk(qf, gf, r=12, k1=6, k2=3, device="cpu")
    chunked = rerank_topk(qf, gf, r=12, k1=6, k2=3, q_chunk=5, device="cpu")
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    d, i = rerank_topk(np.zeros((0, 8)), gf, device="cpu")
    assert d.shape == i.shape == (0, 0)


def test_windowed_core_matches_jax_on_given_windows():
    """``_windowed`` on the same candidate windows (a kernel-dtype gallery
    copy too: the rows widen to fp32 first)."""
    qf, gf = _feats(10, q=7, g=30, d=16)
    rng = np.random.RandomState(10)
    idx = np.stack([rng.permutation(30)[:12] for _ in range(7)])
    ref = np.asarray(J._windowed(qf, gf, idx, 0.3, 7, 4, 3, 4, "euclidean"))
    got = T._windowed(torch.from_numpy(qf), torch.from_numpy(gf),
                      torch.from_numpy(idx), 0.3, 7, 4, 3, 4, "euclidean")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    g16 = torch.from_numpy(gf).to(torch.bfloat16)
    got16 = T._windowed(torch.from_numpy(qf), g16, torch.from_numpy(idx),
                        0.3, 7, 4, 3, 4, "euclidean")
    ref16 = np.asarray(J._windowed(qf, g16.float().numpy(), idx, 0.3, 7, 4,
                                   3, 4, "euclidean"))
    np.testing.assert_allclose(got16.numpy(), ref16, rtol=0, atol=ATOL)
