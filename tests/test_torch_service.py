"""The serving slice: the port's RetrievalService against the JAX package's
on the same weights, uint8 queries and gallery (resnet18, 64x32, fp32
embed, or the int8 PTQ embed from one artifact). The JAX service selects on
its Pallas kernels in interpret mode.

Tolerance: indices equal; distances are exact fp32 re-scores of the same
rows, so they differ only by the embeddings' fp32 conv/reduction order
(rtol 1e-4, atol 1e-4)."""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg
from centroids_reid_tpu.inference import service as jservice
from centroids_reid_tpu.models import create_model as jax_create_model
from centroids_reid_tpu.ops import retrieval_int8 as jax_retrieval_int8
from centroids_reid_tpu.ops.retrieval import topk_select as jax_topk_select
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.inference.service import embed_query
from centroids_reid_tpu_torch.models import ReidModel, from_jax_params
from torch_oracle import randomize_params, randomize_stats


def _cfg():
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    return cfg


@pytest.fixture(scope="module")
def slice_setup():
    """JAX model bundle, the same weights in the port, a gallery of 48
    embedded images + 200 random rows, and 6 queries (4 of them gallery
    images)."""
    cfg = _cfg()
    model = jax_create_model(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 32, 3)))
    params = randomize_params(jax.tree.map(np.asarray, v["params"]), 0)
    stats = randomize_stats(jax.tree.map(np.asarray, v["batch_stats"]), 1)
    port = ReidModel("resnet18", last_stride=1)
    port.load_state_dict(from_jax_params(params, stats), strict=False)

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (48, 64, 32, 3)).astype(np.uint8)
    mean, std = np.array(cfg.INPUT.PIXEL_MEAN), np.array(cfg.INPUT.PIXEL_STD)
    x = ((imgs / 255.0 - mean) / std).astype(np.float32)
    emb = np.asarray(jax.jit(lambda x: model.apply(
        {"params": params, "batch_stats": stats}, x, method=model.embed))(x))
    emb = np.concatenate([emb, rng.randn(200, 512).astype(np.float32)])
    queries = np.concatenate([
        imgs[[3, 17, 30, 47]],
        rng.randint(0, 256, (2, 64, 32, 3)).astype(np.uint8),
    ])
    paths = np.array([f"g{i:03d}" for i in range(len(emb))])
    return cfg, (model, params, stats), port.eval(), emb, paths, queries


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _serve_both(slice_setup, monkeypatch, **kw):
    """The same queries through the JAX and the port's service built with
    ``kw`` (``jax_int8_qfn`` goes to the JAX service as its ``int8_qfn``);
    asserts equal indices and paths, close distances, and each gallery
    image's top-1 its own row. Returns the port's service and answer."""
    cfg, bundle, port, emb, paths, queries = slice_setup
    monkeypatch.setattr(jservice, "topk_select",
                        functools.partial(jax_topk_select, interpret=True))
    monkeypatch.setattr(
        jax_retrieval_int8, "topk_select_int8",
        functools.partial(jax_retrieval_int8.topk_select_int8,
                          interpret=True))
    jax_kw = dict(kw)
    if "jax_int8_qfn" in kw:  # the int8 embed of each package
        jax_kw["int8_qfn"] = jax_kw.pop("jax_int8_qfn")
        del kw["jax_int8_qfn"]
    ref = jservice.RetrievalService(cfg, emb, paths, model_bundle=bundle,
                                    **jax_kw)
    svc = RetrievalService(cfg, emb, paths, device="cpu", model=port, **kw)
    rd, ri, rp = ref.query_arrays(queries)
    d, i, p = svc.query_arrays(queries)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_allclose(d, rd, rtol=1e-4, atol=1e-4)
    assert (i[:4, 0] == [3, 17, 30, 47]).all()
    return svc, d, i


@pytest.mark.parametrize("bf16,k", [(True, 5), (True, 40), (False, 5)])
def test_service_matches_jax(slice_setup, monkeypatch, bf16, k):
    """bf16 k=5 runs K2, bf16 k=40 K1 + the hierarchical top-k on K3, fp32
    the exact path. query_bytes (PNG, lossless) answers as query_arrays."""
    svc, d, i = _serve_both(slice_setup, monkeypatch, k=k,
                            use_bf16_kernel=bf16)
    queries = slice_setup[-1]
    db, ib, _ = svc.query_bytes([_png(q) for q in queries])
    np.testing.assert_array_equal(ib, i)
    np.testing.assert_array_equal(db, d)


@pytest.mark.parametrize("k", [5, 40])
def test_service_without_exact_rescore_matches_jax(slice_setup, monkeypatch,
                                                   k):
    """exact_rescore=False keeps no fp32 gallery copy: both packages
    re-score the winners from the bf16 rows in fp32 arithmetic."""
    svc, _, _ = _serve_both(slice_setup, monkeypatch, k=k,
                            use_bf16_kernel=True, exact_rescore=False)
    assert svc._gf32 is svc._gf and svc._gf.dtype == torch.bfloat16


class _IntegerEmbed(torch.nn.Module):
    """Stands in for the model: an integer-valued 8-d embedding of the
    normalised image, so every distance is an exact fp32 integer."""

    def embed(self, x):
        return torch.round(x.float().flatten(1)[:, :8] * 2)


def test_service_refuses_k_beyond_one_kpass_row(slice_setup):
    """k=5000 against 40,960 gallery rows, beyond one K3 row, is answered
    as the reference answers it (a stable sort where the row is wider than
    32768 columns): equal to the JAX package's ``ranked_query`` on the same
    embeddings and gallery, exactly, since every distance is an integer."""
    cfg, _, _, _, _, queries = slice_setup
    rng = np.random.RandomState(9)
    gallery = rng.randint(-6, 7, (40960, 8)).astype(np.float32)
    paths = np.array([str(r) for r in range(40960)])
    stub = _IntegerEmbed()
    svc = RetrievalService(cfg, gallery, paths, k=5000, normalize=False,
                           use_bf16_kernel=False, device="cpu", model=stub)
    d, i, p = svc.query_arrays(queries)
    e = embed_query(stub, torch.from_numpy(queries), cfg.INPUT.PIXEL_MEAN,
                    cfg.INPUT.PIXEL_STD, torch.float32, normalize=False)
    gn = (gallery * gallery).sum(axis=1)[None, :]
    rd, ri = jservice.ranked_query(jnp.asarray(e.numpy()),
                                   jnp.asarray(gallery), jnp.asarray(gallery),
                                   jnp.asarray(gn), 5000, use_pallas=False)
    np.testing.assert_array_equal(i, np.asarray(ri))
    np.testing.assert_array_equal(d, np.asarray(rd))
    np.testing.assert_array_equal(p, paths[i])
    assert d.shape == (len(queries), 5000)


def test_service_chunks_large_batches(slice_setup):
    """A batch above max_query_batch runs in padded chunks with the same
    answers; k > 32 clamps max_query_batch against the score budget."""
    cfg, _, port, emb, paths, queries = slice_setup
    whole = RetrievalService(cfg, emb, paths, k=5, device="cpu", model=port)
    chunked = RetrievalService(cfg, emb, paths, k=5, device="cpu", model=port,
                               max_query_batch=4)
    for a, b in zip(whole.query_arrays(queries), chunked.query_arrays(queries)):
        np.testing.assert_array_equal(a, b)
    from centroids_reid_tpu_torch.ops.retrieval import _SCORE_BUDGET_BYTES

    wide = RetrievalService(cfg, emb, paths, k=40, device="cpu", model=port,
                            max_query_batch=1 << 20)
    assert wide.max_query_batch == _SCORE_BUDGET_BYTES // (1024 * 4) // 128 * 128

