"""Re-ranked serving: the port's ``RetrievalService(rerank_window=r)``
against the JAX package's on the weights, gallery and queries of
test_torch_service.py (resnet18, 64x32, fp32 embed), the JAX service
selecting on its Pallas kernels in interpret mode. Selection at depth r
runs K2 (bf16, r <= 32), K1 + the hierarchical top-k on K3 (bf16, r > 32),
the exact fp32 path, or K4 + K3 (int8 gallery); each query's window is
then re-ranked (``ops.rerank._windowed``).

Tolerances: indices equal. The two services' embeddings differ by the
fp32 conv / reduction order (test_torch_service.py), which moves the
re-rank scores (in [0, 1]) by up to a few 1e-5: served scores within 1e-4.
On the same embeddings and gallery rows, ``reranked_query`` and
``reranked_query_int8`` agree with the JAX package's within 1e-5."""

import functools

import numpy as np
import pytest

from centroids_reid_tpu.inference import service as jservice
from centroids_reid_tpu.ops import retrieval_int8 as jax_retrieval_int8
from centroids_reid_tpu.ops.retrieval import topk_select as jax_topk_select
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.ops.retrieval import _SCORE_BUDGET_BYTES
from test_torch_service import slice_setup  # noqa: F401

RERANK = dict(rerank_k1=6, rerank_k2=3, rerank_lambda=0.3)


def _serve_both(slice_setup, monkeypatch, **kw):
    """The queries through the JAX and the port's service built with
    ``kw``: equal indices and paths, scores within 1e-4, and each gallery
    image's top-1 its own row. Returns the port's service and answer."""
    cfg, bundle, port, emb, paths, queries = slice_setup
    monkeypatch.setattr(jservice, "topk_select",
                        functools.partial(jax_topk_select, interpret=True))
    monkeypatch.setattr(
        jax_retrieval_int8, "topk_select_int8",
        functools.partial(jax_retrieval_int8.topk_select_int8,
                          interpret=True))
    ref = jservice.RetrievalService(cfg, emb, paths, model_bundle=bundle,
                                    **kw)
    svc = RetrievalService(cfg, emb, paths, device="cpu", model=port, **kw)
    rd, ri, rp = ref.query_arrays(queries)
    d, i, p = svc.query_arrays(queries)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_allclose(d, rd, rtol=0, atol=1e-4)
    assert d.shape == (len(queries), svc.k)
    assert (i[:4, 0] == [3, 17, 30, 47]).all()
    return svc, d, i


@pytest.mark.parametrize("kw", [
    dict(rerank_window=20),                            # K2 window
    dict(rerank_window=40),                            # K1 + K3 window
    dict(rerank_window=40, use_bf16_kernel=False),     # exact fp32 window
    dict(rerank_window=40, use_int8_gallery=True),     # K4 + K3 window
], ids=["bf16-r20", "bf16-r40", "fp32-r40", "int8-r40"])
def test_reranked_service_matches_jax(slice_setup, monkeypatch, kw):
    svc, d, i = _serve_both(slice_setup, monkeypatch, k=5, **RERANK, **kw)
    assert svc.rerank_window == kw["rerank_window"]
    assert (np.diff(d, axis=1) >= 0).all()
    if kw.get("use_int8_gallery"):
        assert svc._int8_sel == 40 + 16   # default_margin of the window


def test_reranked_service_cosine_matches_jax(slice_setup, monkeypatch):
    """SOLVER.DISTANCE_FUNC='cosine' is the re-rank's local distance (on
    normalised rows)."""
    cfg = slice_setup[0].clone()
    cfg.SOLVER.DISTANCE_FUNC = "cosine"
    setup = (cfg, *slice_setup[1:])
    svc, _, _ = _serve_both(setup, monkeypatch, k=5, rerank_window=30,
                            **RERANK)
    assert svc._rerank_dist == "cosine"


def test_rerank_window_clamps(slice_setup):
    """r below k rises to k, r beyond the gallery falls to it, as in the
    JAX service; a clamped service answers as one built at the clamped
    window."""
    cfg, bundle, port, emb, paths, queries = slice_setup
    for k, r, g in ((8, 3, len(paths)), (5, 500, 30)):
        ref = jservice.RetrievalService(cfg, emb[:g], paths[:g],
                                        model_bundle=bundle, k=k,
                                        rerank_window=r)
        svc = RetrievalService(cfg, emb[:g], paths[:g], k=k, rerank_window=r,
                               device="cpu", model=port, **RERANK)
        assert svc.rerank_window == ref.rerank_window == min(max(r, k), g)
        twin = RetrievalService(cfg, emb[:g], paths[:g], k=k,
                                rerank_window=svc.rerank_window,
                                device="cpu", model=port, **RERANK)
        for a, b in zip(svc.query_arrays(queries),
                        twin.query_arrays(queries)):
            np.testing.assert_array_equal(a, b)
    assert RetrievalService(cfg, emb, paths, k=5, device="cpu",
                            model=port).rerank_window == 0


def test_rerank_window_sets_the_route_and_batch_clamp(slice_setup):
    """The selection depth is ``rerank_window or k``: at k = 10, r = 100
    the window takes the [B, G] score route, so max_query_batch is clamped
    against the score budget though k <= 32."""
    cfg, _, port, emb, paths, _ = slice_setup
    cap = _SCORE_BUDGET_BYTES // (1024 * 4) // 128 * 128
    plain = RetrievalService(cfg, emb, paths, k=10, device="cpu", model=port,
                             max_query_batch=1 << 20)
    reranked = RetrievalService(cfg, emb, paths, k=10, rerank_window=100,
                                device="cpu", model=port,
                                max_query_batch=1 << 20)
    assert plain.max_query_batch == 1 << 20
    assert reranked.max_query_batch == cap


@pytest.mark.parametrize("kw,match", [
    (dict(normalize=False), "cosine"),
    (dict(use_int8_gallery=True, exact_rescore=False), "re-rank"),
])
def test_reranked_service_refusals_match_jax(slice_setup, kw, match):
    """Cosine re-ranking needs normalised rows; the int8 capacity mode keeps
    no full-precision rows to re-rank. Both packages refuse."""
    cfg, bundle, port, emb, paths, _ = slice_setup
    cfg = cfg.clone()
    cfg.SOLVER.DISTANCE_FUNC = "cosine"
    with pytest.raises(ValueError, match=match):
        jservice.RetrievalService(cfg, emb, paths, model_bundle=bundle,
                                  rerank_window=20, **kw)
    with pytest.raises(ValueError, match=match):
        RetrievalService(cfg, emb, paths, rerank_window=20, device="cpu",
                         model=port, **kw)


@pytest.mark.parametrize("route", ["bf16-k2", "bf16-k1k3", "fp32",
                                   "bf16-rows", "int8"])
def test_reranked_query_matches_jax_on_the_same_embeddings(monkeypatch,
                                                           route):
    """The service's ranking half on identical fp32 embeddings and gallery:
    selection of the r-window on each route, then the re-rank (on the
    bf16 rows themselves with ``bf16-rows``, the service's
    ``exact_rescore=False``)."""
    import jax.numpy as jnp
    import torch

    from centroids_reid_tpu.ops import retrieval_int8 as JI8
    from centroids_reid_tpu_torch.inference import service as tservice
    from centroids_reid_tpu_torch.ops.retrieval_int8 import quantize_gallery

    monkeypatch.setattr(jservice, "topk_select",
                        functools.partial(jax_topk_select, interpret=True))
    monkeypatch.setattr(JI8, "topk_select_int8",
                        functools.partial(JI8.topk_select_int8,
                                          interpret=True))
    rng = np.random.RandomState(11)
    g, real = 1024, 1000
    gf = rng.randn(g, 32).astype(np.float32)
    gf /= np.linalg.norm(gf, axis=1, keepdims=True)
    gf[real:] = 0
    e = gf[[3, 500, 999]] + 0.05 * rng.randn(3, 32).astype(np.float32)
    gn = (gf * gf).sum(1)
    gn[real:] = np.inf
    r = 20 if route == "bf16-k2" else 40
    args = (5, r, 6, 3, 0.3)
    if route == "int8":
        gal = quantize_gallery(torch.from_numpy(gf))
        gal = gal._replace(gn=torch.cat([gal.gn[:real],
                                         gal.gn.new_full((g - real,),
                                                         float("inf"))]))
        jgal = JI8.Int8Gallery(jnp.asarray(gal.codes.numpy()),
                               jnp.asarray(gal.scale.numpy()),
                               jnp.asarray(gal.gn.numpy()))
        sel = JI8.default_margin(r)
        rd, ri = jservice.reranked_query_int8(
            jnp.asarray(e), jgal, jnp.asarray(gf[:real]), *args, sel=sel)
        d, i = tservice.reranked_query_int8(
            torch.from_numpy(e), gal, torch.from_numpy(gf[:real]), *args,
            sel=sel)
    else:
        dtype = torch.float32 if route == "fp32" else torch.bfloat16
        gk = torch.from_numpy(gf).to(dtype)
        jgk = jnp.asarray(gk.float().numpy()).astype(
            jnp.float32 if route == "fp32" else jnp.bfloat16)
        rows = gk if route == "bf16-rows" else torch.from_numpy(gf[:real])
        jrows = jgk if route == "bf16-rows" else jnp.asarray(gf[:real])
        rd, ri = jservice.reranked_query(jnp.asarray(e), jgk, jrows,
                                         jnp.asarray(gn[None]), *args)
        d, i = tservice.reranked_query(torch.from_numpy(e), gk, rows,
                                       torch.from_numpy(gn[None]), *args)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=1e-5)
    assert (i[:, 0].numpy() == [3, 500, 999]).all()
