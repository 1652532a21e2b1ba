"""Serving artifacts: the port's ``inference/export.py`` against the JAX
package's on the same weights (resnet18, 32x16, fp32), and against the
port's live serving path.

The same numpy uint8 inputs go through the JAX package's artifacts
(``export_embedder`` / ``export_retriever`` for the CPU, loaded by its
loaders, exact fp32 selection) and through the port's (one program for
the CPU). Tolerances:

* against JAX: rtol 1e-4, atol 1e-4 (the two packages' fp32 conv and
  reduction orders, as in test_torch_service.py); indices equal;
* against the port's live ``embed_query`` / ``RetrievalService``: within
  1e-6, identical expected (the exported program runs the same ATen ops).

The retriever artifacts are in test_torch_export_retriever.py, the int8
ones in test_torch_export_int8.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.inference import export as jexport
from centroids_reid_tpu.models import create_model as jax_create_model
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.inference import export as X
from centroids_reid_tpu_torch.inference.service import embed_query
from centroids_reid_tpu_torch.models import ReidModel, from_jax_params
from torch_oracle import randomize_params, randomize_stats

HW = (32, 16)
TOL = dict(rtol=1e-4, atol=1e-4)


def small_cfg(make, **opts):
    cfg = make()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = list(HW)
    for key, value in opts.items():
        node, leaf = key.rsplit(".", 1)
        setattr(getattr(cfg, node), leaf, value)
    return cfg


def imgs(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3), np.uint8)


@pytest.fixture(scope="module")
def models():
    """One set of random weights in both packages: the JAX (model, params,
    batch_stats) and the port's ReidModel."""
    cfg = small_cfg(jax_default_cfg)
    model = jax_create_model(cfg, num_classes=0)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    params = randomize_params(jax.tree.map(np.asarray, v["params"]), 0)
    stats = randomize_stats(jax.tree.map(np.asarray, v["batch_stats"]), 1)
    port = ReidModel("resnet18", last_stride=1)
    port.load_state_dict(from_jax_params(params, stats), strict=False)
    rng = np.random.RandomState(2)
    gallery = rng.randn(40, 512).astype(np.float32)
    paths = np.array([f"g{i:03d}" for i in range(40)])
    return (model, params, stats), port.eval(), gallery, paths


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """The JAX package's symbolic-batch embedder; the port's symbolic-batch
    and fixed-batch (4) embedders."""
    (model, params, stats), port, _, _ = models
    tmp = tmp_path_factory.mktemp("artifacts")
    blob, meta = jexport.export_embedder(model, small_cfg(jax_default_cfg),
                                         params, stats, platforms=("cpu",))
    out = {"jax_embedder": str(tmp / "jax_embedder.crtpu")}
    jexport.save_artifact(out["jax_embedder"], blob, meta)
    cfg = small_cfg(get_default_cfg)
    for name, batch in (("embedder", None), ("fixed", 4)):
        blobs, meta = X.export_embedder(port, cfg, platforms=("cpu",),
                                        batch_size=batch)
        out[name] = str(tmp / f"{name}.crt")
        X.save_artifact(out[name], blobs, meta)
    return out


def _live_embed(port, x, normalize=True):
    cfg = small_cfg(get_default_cfg)
    with torch.inference_mode():
        return embed_query(port, torch.from_numpy(x), cfg.INPUT.PIXEL_MEAN,
                           cfg.INPUT.PIXEL_STD, torch.float32,
                           normalize).numpy()


@pytest.mark.parametrize("n", [1, 3, 7])
def test_symbolic_embedder_matches_jax_and_live(models, artifacts, n):
    """One symbolic-batch program at B = 1, 3 and 7."""
    _, port, _, _ = models
    emb = X.load_embedder(artifacts["embedder"], "cpu")
    assert emb.meta["batch_size"] is None and emb.meta["emb_dim"] == 512
    assert emb.meta["platforms"] == ["cpu"] and emb.model_name == "resnet18"
    x = imgs(n, 10 + n)
    got = emb.embed(x)
    want = jexport.load_embedder(artifacts["jax_embedder"]).embed(x)
    assert got.shape == (n, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _live_embed(port, x), rtol=0, atol=1e-6)


def test_fixed_batch_embedder_pads_partial(models, artifacts):
    _, port, _, _ = models
    emb = X.load_embedder(artifacts["fixed"], "cpu")
    assert emb.meta["batch_size"] == 4
    x = imgs(6, 20)                              # 4 + a partial 2
    got = emb.embed(x)
    want = jexport.load_embedder(artifacts["jax_embedder"]).embed(x)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:4], _live_embed(port, x[:4]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[4:], _live_embed(port, x[4:]), rtol=0,
                               atol=1e-6)
    assert emb.embed(x[:0]).shape == (0, 512)    # zero-row output contract
    assert emb.num_compiles == 1                 # one program shape


def test_artifact_validation(artifacts, tmp_path):
    bad = tmp_path / "bad.crt"
    bad.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="bad magic"):
        X.read_artifact(str(bad))
    # a JAX artifact is named and refused
    with pytest.raises(ValueError, match="StableHLO artifact of the JAX"):
        X.load_embedder(artifacts["jax_embedder"], "cpu")
    assert X.MAGIC != jexport.MAGIC and len(X.MAGIC) == len(jexport.MAGIC)

    v999 = str(tmp_path / "v999.crt")
    X.save_artifact(v999, {"cpu": b"blob"},
                    {"format_version": 999, "kind": "embedder"})
    with pytest.raises(ValueError, match="format v999"):
        X.read_artifact(v999)
    kind = str(tmp_path / "kind.crt")
    X.save_artifact(kind, {"cpu": b"blob"},
                    {"format_version": X.FORMAT_VERSION, "kind": "other"})
    with pytest.raises(ValueError, match="kind"):
        X.load_embedder(kind, "cpu")
    with pytest.raises(ValueError, match="kind"):
        X.load_retriever(artifacts["embedder"], "cpu")
    # a truncated file
    with open(artifacts["embedder"], "rb") as f:
        raw = f.read()
    cut = tmp_path / "cut.crt"
    cut.write_bytes(raw[:-100])
    with pytest.raises(ValueError, match="truncated"):
        X.load_embedder(str(cut), "cpu")
    # a device type the file holds no program for: no other stands in
    with pytest.raises(ValueError, match="no program for device type 'cuda'"):
        X.load_embedder(artifacts["embedder"], "cuda")
    with pytest.raises(ValueError, match="platforms"):
        X.export_embedder(None, small_cfg(get_default_cfg),
                          platforms=("tpu",))
    _, meta = X.read_artifact(artifacts["embedder"])
    assert meta["format_version"] == X.FORMAT_VERSION
    assert "aux_bytes" not in meta and "jax_version" not in meta
    assert meta["platforms"] == ["cpu"] and "torch_version" in meta


def test_warmup_and_num_compiles(artifacts):
    emb = X.load_embedder(artifacts["embedder"], "cpu")
    with pytest.raises(ValueError, match="batch_sizes"):
        emb.warmup()
    emb.warmup(batch_sizes=[2, 5])
    n0 = emb.num_compiles
    assert n0 == 2
    emb.embed(imgs(2, 50))
    emb.embed(imgs(5, 51))
    assert emb.num_compiles == n0            # served shapes were warmed
    fixed = X.load_embedder(artifacts["fixed"], "cpu")
    fixed.warmup()
    fixed.embed(imgs(7, 52))                 # pads to 4s
    assert fixed.num_compiles == 1


def test_export_model_cli_from_reference_pth(models, tmp_path):
    """The CLI from a reference-layout ``.pth``: the embedder and the
    retriever (from a create_embeddings index) equal the live path on the
    model ``load_inference_model`` reads from the same file."""
    from centroids_reid_tpu_torch.inference import export_model
    from centroids_reid_tpu_torch.inference.api import load_inference_model

    _, port, gallery, paths = models
    pth = str(tmp_path / "reid.pth")
    torch.save({"state_dict": port.state_dict()}, pth)
    index = tmp_path / "index"
    index.mkdir()
    np.save(index / "embeddings.npy", gallery)
    np.save(index / "paths.npy", paths)
    opts = ["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE", "512",
            "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TEST", "[32,16]",
            "MODEL.PRETRAIN_PATH", pth, "TEST.IMS_PER_BATCH", "4"]
    out = str(tmp_path / "cli.crt")
    meta = export_model.main(["--output", out, "--platforms", "cpu",
                              "--device", "cpu", *opts])
    assert meta["kind"] == "embedder" and meta["quantized"] is False
    ret_out = str(tmp_path / "cli_ret.crt")
    meta = export_model.main(["--output", ret_out, "--platforms", "cpu",
                              "--device", "cpu", "--retriever",
                              "--gallery_data", str(index), "--topk", "3",
                              *opts])
    assert meta["batch_size"] == 4 and meta["k"] == 3
    cfg = small_cfg(get_default_cfg, **{"MODEL.PRETRAIN_PATH": pth})
    live = load_inference_model(cfg, "cpu")
    x = imgs(3, 60)
    np.testing.assert_allclose(X.load_embedder(out, "cpu").embed(x),
                               _live_embed(live, x), rtol=0, atol=1e-6)
    svc = RetrievalService(cfg, gallery, paths, k=3, use_bf16_kernel=False,
                           device="cpu", model=live)
    d, i, p = X.load_retriever(ret_out, "cpu").query_arrays(x)
    sd, si, sp = svc.query_arrays(x)
    np.testing.assert_array_equal(i, si)
    np.testing.assert_array_equal(p, sp)
    np.testing.assert_allclose(d, sd, rtol=0, atol=1e-6)
    with pytest.raises(SystemExit, match="gallery_data"):
        export_model.main(["--output", ret_out, "--retriever", *opts])
    assert os.path.getsize(ret_out) > os.path.getsize(out)
