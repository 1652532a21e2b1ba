"""int8 serving artifacts: the port's int8 embedder and retriever
artifacts against the JAX package's, both exported from one calibrated
int8 cache (resnet18, 32x16, fused convs with int32 accumulators: the
port's K5 / K6 operators, the JAX package's Pallas kernels in interpret
mode), and against the port's live ``QuantizedEmbed``.

Tolerances: against JAX, the bounds of the JAX package's own int8 export
tests (tests/test_export.py): embedding cosine > 0.99, top-1 equal,
distances within 5e-2 (the two programs round their requantizations in
another float association, which moves activations by a quantum at
rounding boundaries). Against the port's live path: within 1e-6,
identical expected (the program runs the live engine's ops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.inference import export as jexport
from centroids_reid_tpu.models.quantized import (
    quantize_reid_model as jax_quantize,
)
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.inference import export as X
from centroids_reid_tpu_torch.models.quantized import (
    QuantizedEmbed,
    QuantizedEmbedModule,
    serving_identity,
)
from centroids_reid_tpu_torch.ops import int8_conv
from test_torch_export import imgs, models, small_cfg  # noqa: F401

K = 4


@pytest.fixture(scope="module")
def int8(models, tmp_path_factory):
    """One int8 cache calibrated by the JAX package and loaded by both;
    each package's int8 embedder and retriever (batch 4, k = 4)."""
    (model, params, stats), port, gallery, paths = models
    tmp = tmp_path_factory.mktemp("int8")
    jcfg, cfg = small_cfg(jax_default_cfg), small_cfg(get_default_cfg)
    jq = jax_quantize(model, params, stats, [imgs(8, 70)],
                      jcfg.INPUT.PIXEL_MEAN, jcfg.INPUT.PIXEL_STD,
                      use_pallas=True, acc_dtype=jnp.int32)
    cache = str(tmp / "int8.npz")
    jq.save(cache, extra_meta={"origin": "jax"})
    qfn = QuantizedEmbed.load(cache, "cpu")
    assert qfn._use_pallas is True and qfn._acc_dtype == torch.int32
    out = {"qfn": qfn, "cache": cache}
    blob, meta = jexport.export_embedder(model, jcfg, params, stats,
                                         platforms=("cpu",), batch_size=4,
                                         int8_qfn=jq)
    out["jax_embedder"] = str(tmp / "jax_int8.crtpu")
    jexport.save_artifact(out["jax_embedder"], blob, meta)
    blob, meta, aux = jexport.export_retriever(
        model, jcfg, params, stats, gallery, paths, k=K, batch_size=4,
        platforms=("cpu",), int8_qfn=jq)
    out["jax_retriever"] = str(tmp / "jax_int8_ret.crtpu")
    jexport.save_artifact(out["jax_retriever"], blob, meta, aux=aux)
    blobs, meta = X.export_embedder(port, cfg, platforms=("cpu",),
                                    batch_size=4, int8_qfn=qfn)
    assert meta["quantized"] is True
    out["embedder"] = str(tmp / "int8.crt")
    X.save_artifact(out["embedder"], blobs, meta)
    blobs, meta, aux = X.export_retriever(port, cfg, gallery, paths, k=K,
                                          batch_size=4, platforms=("cpu",),
                                          int8_qfn=qfn)
    assert meta["quantized"] is True and meta["ingest"] == "rgb"
    out["retriever"] = str(tmp / "int8_ret.crt")
    X.save_artifact(out["retriever"], blobs, meta, aux=aux)
    return out


def _unit(e):
    return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)


def _op_nodes(program):
    names = [str(n.target) for n in program.graph.nodes]
    return (names.count("crt.matmul_requant.default"),
            names.count("crt.conv3x3_requant.default"))


def test_int8_embedder_matches_jax_and_live(int8, monkeypatch):
    """The program calls K5 / K6 as the live engine does, one operator node
    per fused conv, and reads pre-packed weights (no packing inside)."""
    emb = X.load_embedder(int8["embedder"], "cpu")
    assert emb.meta["batch_size"] == 4 and emb.meta["quantized"]
    x = imgs(6, 71)                                # 4 + a partial 2
    got = emb.embed(x)
    want = jexport.load_embedder(int8["jax_embedder"]).embed(x)
    assert got.shape == want.shape == (6, 512)
    cos = np.sum(got * want, axis=1)
    assert cos.min() > 0.99, cos

    calls = {"matmul_requant": 0, "conv3x3_requant": 0}
    for name in calls:
        real = getattr(int8_conv, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(int8_conv, name, counted)
    qfn = int8["qfn"]
    live = np.concatenate([_unit(qfn(x[:4]).numpy()),
                           _unit(qfn(x[4:]).numpy())])
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-6)
    assert _op_nodes(emb.program) == (calls["matmul_requant"] // 2,
                                      calls["conv3x3_requant"] // 2)
    assert _op_nodes(emb.program) == (3, 14)       # resnet18 at 32x16


def test_int8_view_packs_every_fused_weight(int8):
    """QuantizedEmbedModule bakes one K-major copy per fused conv; its
    forward equals the live embed."""
    qfn = int8["qfn"]
    view = QuantizedEmbedModule(qfn)
    assert len(view._packs) == 17
    x = torch.from_numpy(imgs(4, 72))
    with torch.inference_mode():
        np.testing.assert_array_equal(view(x).numpy(), qfn(x).numpy())
    unfused = QuantizedEmbed(qfn.qtree, qfn._static["plan"],
                             qfn._static["stem_relu"], use_pallas=False)
    assert QuantizedEmbedModule(unfused)._packs == []


def test_int8_retriever_matches_jax_and_live(models, int8):
    _, port, gallery, paths = models
    ret = X.load_retriever(int8["retriever"], "cpu")
    x = imgs(7, 73)
    d, i, _ = ret.query_arrays(x)
    jd, ji, _ = jexport.load_retriever(
        int8["jax_retriever"], use_bf16_kernel=False,
        use_pallas=False).query_arrays(x)
    assert (i[:, 0] == ji[:, 0]).all()
    np.testing.assert_allclose(d, jd, rtol=0, atol=5e-2)
    svc = RetrievalService(small_cfg(get_default_cfg), gallery, paths, k=K,
                           use_bf16_kernel=False, device="cpu", model=port,
                           int8_qfn=int8["qfn"])
    sd, si, _ = svc.query_arrays(x[:4])
    np.testing.assert_array_equal(i[:4], si)
    np.testing.assert_allclose(d[:4], sd, rtol=0, atol=1e-6)


def test_int8_export_needs_a_fixed_batch(models, int8):
    with pytest.raises(ValueError, match="batch_size"):
        X.export_embedder(models[1], small_cfg(get_default_cfg),
                          platforms=("cpu",), int8_qfn=int8["qfn"])


def test_int8_export_from_config_refuses_missing_and_stale_cache(
        models, tmp_path):
    """Without TPU.INT8_CACHE_PATH, and with a cache calibrated for another
    identity, the export refuses before writing anything; with the
    matching identity it exports the cache's program."""
    port = models[1]
    pth = str(tmp_path / "reid.pth")
    torch.save({"state_dict": port.state_dict()}, pth)
    cfg = small_cfg(get_default_cfg, **{
        "TPU.INT8_EVAL": True, "MODEL.PRETRAIN_PATH": pth,
        "TEST.IMS_PER_BATCH": 4,
        "TPU.INT8_CACHE_PATH": str(tmp_path / "missing")})
    out = str(tmp_path / "out.crt")
    with pytest.raises(ValueError, match="calibrated artifact"):
        X.export_from_config(cfg, out, platforms=("cpu",), device="cpu")
    cfg.TPU.INT8_CACHE_PATH = str(tmp_path / "cache.npz")
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model

    qfn = quantize_reid_model(port, [imgs(4, 74)], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD)
    qfn.save(cfg.TPU.INT8_CACHE_PATH, extra_meta={"stale": True})
    with pytest.raises(ValueError, match="calibrated for"):
        X.export_from_config(cfg, out, platforms=("cpu",), device="cpu")
    assert not (tmp_path / "out.crt").exists()
    qfn.save(cfg.TPU.INT8_CACHE_PATH, extra_meta=serving_identity(cfg, port))
    meta = X.export_from_config(cfg, out, platforms=("cpu",), device="cpu")
    assert meta["quantized"] is True and meta["batch_size"] == 4
    x = imgs(4, 75)
    np.testing.assert_allclose(X.load_embedder(out, "cpu").embed(x),
                               _unit(qfn(x).numpy()), rtol=0, atol=1e-6)
