"""Sharded serving: the port's ``RetrievalService(mesh=)`` on a mesh of 8
CPU shards against the JAX package's sharded service on its 8-device
virtual CPU mesh, and against the port's one-device service, on the same
weights (resnet18, 32x16, fp32 embed), uint8 queries and gallery. The
gallery has 403 rows: not a multiple of 8, and 51 rows a JAX shard (128 a
port shard, K1's tile), so the re-rank window of 60 is wider than a JAX
shard.

Tolerances: indices and paths equal to the JAX sharded service's.
Distances are exact fp32 re-scores (or re-rank scores in [0, 1]) of the
same rows, so they differ only by the embeddings' fp32 conv / reduction
order across packages: 1e-4. Against the port's one-device service: on
the fp32 route indices equal and distances within 1e-5. On the bf16 route
the sharded service picks each shard's candidates at bf16 score
resolution and merges them by exact distance, so it chooses from a
superset of the one-device service's candidates, which random gallery
rows tie at bf16 resolution: at every rank its distance is at most the
one-device service's, plus 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg
from centroids_reid_tpu.inference import service as jservice
from centroids_reid_tpu.models import create_model as jax_create_model
from centroids_reid_tpu.models import quantized as JQ
from centroids_reid_tpu.parallel import make_retrieval_mesh as jax_mesh
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.models import ReidModel, from_jax_params
from centroids_reid_tpu_torch.models import quantized as TQ
from centroids_reid_tpu_torch.ops.retrieval import _SCORE_BUDGET_BYTES
from centroids_reid_tpu_torch.parallel import make_retrieval_mesh
from torch_oracle import randomize_params, randomize_stats

OWN = [3, 10, 17, 23]          # gallery rows of the first four queries
RERANK = dict(rerank_k1=6, rerank_k2=3, rerank_lambda=0.3)


def _cfg():
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [32, 16]
    return cfg


@pytest.fixture(scope="module")
def setup():
    """JAX model bundle, the same weights in the port, a gallery of 24
    embedded images + 379 random rows, 6 queries (4 of them gallery
    images), and the two meshes."""
    cfg = _cfg()
    model = jax_create_model(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 16, 3)))
    params = randomize_params(jax.tree.map(np.asarray, v["params"]), 0)
    stats = randomize_stats(jax.tree.map(np.asarray, v["batch_stats"]), 1)
    port = ReidModel("resnet18", last_stride=1)
    port.load_state_dict(from_jax_params(params, stats), strict=False)

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (24, 32, 16, 3)).astype(np.uint8)
    mean, std = np.array(cfg.INPUT.PIXEL_MEAN), np.array(cfg.INPUT.PIXEL_STD)
    x = ((imgs / 255.0 - mean) / std).astype(np.float32)
    emb = np.asarray(jax.jit(lambda x: model.apply(
        {"params": params, "batch_stats": stats}, x, method=model.embed))(x))
    emb = np.concatenate([emb, rng.randn(379, 512).astype(np.float32)])
    queries = np.concatenate([
        imgs[OWN], rng.randint(0, 256, (2, 32, 16, 3)).astype(np.uint8)])
    paths = np.array([f"g{i:03d}" for i in range(len(emb))])
    meshes = (jax_mesh(8), make_retrieval_mesh(devices=["cpu"] * 8))
    return cfg, (model, params, stats), port.eval(), emb, paths, queries, \
        meshes


def _serve(setup, jax_kw=None, **kw):
    """The queries through the JAX sharded service, the port's sharded and
    the port's one-device service built with ``kw`` (``jax_kw`` overrides
    for the JAX one). The two sharded services' indices and paths equal;
    returns the port's sharded service and the three answers."""
    cfg, bundle, port, emb, paths, queries, (jmesh, mesh) = setup
    ref = jservice.RetrievalService(cfg, emb, paths, model_bundle=bundle,
                                    mesh=jmesh, **{**kw, **(jax_kw or {})})
    svc = RetrievalService(cfg, emb, paths, model=port, mesh=mesh, **kw)
    one = RetrievalService(cfg, emb, paths, device="cpu", model=port, **kw)
    assert ref.mesh is not None and svc.mesh is mesh
    out = [s.query_arrays(queries) for s in (ref, svc, one)]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_array_equal(out[1][2], out[0][2])
    assert (out[1][1][:4, 0] == OWN).all() and (out[2][1][:4, 0] == OWN).all()
    return svc, out


def _against_one_device(got, one, bf16: bool):
    """fp32: the one-device service's indices, distances within 1e-5. bf16:
    at every rank a distance no larger than the one-device one's."""
    if bf16:
        assert (got[0] <= one[0] + 1e-5 * (1 + np.abs(one[0]))).all()
        return
    np.testing.assert_array_equal(got[1], one[1])
    np.testing.assert_allclose(got[0], one[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16,k", [(False, 5), (True, 5), (True, 60)],
                         ids=["fp32-k5", "bf16-k5", "bf16-k60"])
def test_sharded_service_matches_jax(setup, bf16, k):
    """Selection per shard at kernel dtype (K1 + the hierarchical top-k on
    K3 on the card, at any k), exact fp32 re-score of each shard's winners
    against its own rows, the merge."""
    svc, (ref, got, one) = _serve(setup, k=k, use_bf16_kernel=bf16)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)
    _against_one_device(got, one, bf16)
    assert (np.diff(got[0], axis=1) >= 0).all()
    assert svc._gf[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert [tuple(g.shape) for g in svc._gf] == [(128, 512)] * 8


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_sharded_reranked_service_matches_jax(setup, bf16):
    """rerank_window=60: the merged window's rows come from the cross-shard
    gather and are re-ranked by ``_windowed_feats``. On the fp32 route the
    one-device re-ranked service selects the same windows, and the scores
    agree within 1e-5; on the bf16 route the windows may differ (see the
    module's docstring)."""
    svc, (ref, got, one) = _serve(setup, k=5, use_bf16_kernel=bf16,
                                  rerank_window=60, **RERANK)
    assert svc.rerank_window == 60
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
    if not bf16:
        np.testing.assert_array_equal(got[1], one[1])
        np.testing.assert_allclose(got[0], one[0], rtol=0, atol=1e-5)
    assert (np.diff(got[0], axis=1) >= 0).all()


def test_sharded_service_with_an_int8_embed_matches_jax(setup,
                                                        tmp_path_factory):
    """The int8 PTQ embed (one artifact in both packages, int32
    accumulators) feeds the sharded bf16 gallery, as
    tests/test_inference.py composes them in the JAX package."""
    cfg, bundle, *_ = setup
    calib = setup[5][:4]
    jq = JQ.quantize_reid_model(*bundle, [calib], cfg.INPUT.PIXEL_MEAN,
                                cfg.INPUT.PIXEL_STD, acc_dtype=jnp.int32)
    path = str(tmp_path_factory.mktemp("int8") / "q.npz")
    jq.save(path)
    tq = TQ.QuantizedEmbed.load(path, device="cpu")
    svc, (ref, got, _) = _serve(setup, jax_kw={"int8_qfn": jq}, k=5,
                                int8_qfn=tq)
    assert svc.ingest_format == "rgb"
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)


def test_sharded_service_without_exact_rescore(setup):
    """exact_rescore=False keeps no fp32 shards: each shard re-scores its
    winners from its own bf16 rows in fp32 arithmetic, as the one-device
    service does (bf16 selection: compared as in ``_against_one_device``)."""
    cfg, _, port, emb, paths, queries, (_, mesh) = setup
    kw = dict(k=5, exact_rescore=False)
    svc = RetrievalService(cfg, emb, paths, model=port, mesh=mesh, **kw)
    one = RetrievalService(cfg, emb, paths, device="cpu", model=port, **kw)
    assert svc._gf32 is svc._gf
    _against_one_device(svc.query_arrays(queries), one.query_arrays(queries),
                        bf16=True)


def test_sharded_service_clamps_and_one_device_mesh(setup):
    """max_query_batch is clamped on the shard's [B, 128] scores and, when
    re-ranking, on the [B, r, D] gathered rows; a one-device mesh is the
    unsharded service, as in the JAX package; batches beyond the clamp
    answer in chunks as one batch would (distances within 1e-5: the
    embed's conv order depends on the batch)."""
    cfg, _, port, emb, paths, queries, (_, mesh) = setup
    svc = RetrievalService(cfg, emb, paths, k=5, model=port, mesh=mesh,
                           max_query_batch=1 << 30)
    assert svc.max_query_batch == _SCORE_BUDGET_BYTES // (128 * 4)
    rr = RetrievalService(cfg, emb, paths, k=5, model=port, mesh=mesh,
                          rerank_window=60, max_query_batch=1 << 30)
    assert rr.max_query_batch == _SCORE_BUDGET_BYTES // (60 * 512 * 4)
    single = RetrievalService(cfg, emb, paths, k=5, device="cpu",
                              model=port,
                              mesh=make_retrieval_mesh(devices=["cpu"]))
    assert single.mesh is None and single._gf.shape[0] == 1024
    small = RetrievalService(cfg, emb, paths, k=5, model=port, mesh=mesh,
                             max_query_batch=4)
    d, i, _ = small.query_arrays(queries)
    d1, i1, _ = svc.query_arrays(queries)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(d, d1, rtol=1e-5, atol=1e-5)
