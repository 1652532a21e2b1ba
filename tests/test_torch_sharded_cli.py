"""``TPU.SHARDED_RETRIEVAL`` in the port's CLIs against the JAX package's:
``get_similar`` and the HTTP front's ``build_from_args``, the port's
visible devices patched to 8 CPU shards, the JAX package on its 8-device
virtual CPU mesh, on test_torch_cli.py's image folders and reference-format
``.pth`` (resnet18, 32x16, fp32).

Tolerances as in test_torch_cli.py: indices and paths equal; distances
within 1e-4 of ``max ||q||^2 + max ||g||^2`` (the embeddings differ by the
fp32 conv / reduction order)."""

import os

import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.parallel import mesh as pmesh
from test_torch_cli import _cfg, cli_setup, flat_index  # noqa: F401

OPTS = ["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE", "512",
        "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TEST", "[32,16]",
        "TEST.IMS_PER_BATCH", "8"]


@pytest.fixture
def eight_cpus(monkeypatch):
    """The port sees eight devices of ``--device``'s type."""
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device="cuda": [torch.device(device)] * 8)


def _scale(q, g):
    return (q * q).sum(axis=1).max() + (g * g).sum(axis=1).max()


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_get_similar_sharded_matches_jax(cli_setup, flat_index, eight_cpus,
                                         dist):
    """``--topk 6 --normalize_features TPU.SHARDED_RETRIEVAL True``: both
    rank on their 8-shard meshes (``sharded_topk``)."""
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import get_similar

    pth, _, queries, tmp = cli_setup
    jout, tout = flat_index
    jres, tres = str(tmp / f"jsh_{dist}"), str(tmp / f"tsh_{dist}")
    jcfg = _cfg(jax_default_cfg, pth, queries, jres)
    jcfg.TPU.SHARDED_RETRIEVAL = True
    jcfg.SOLVER.DISTANCE_FUNC = dist
    japi.find_similar(jcfg, jout, images_in_subfolders=False,
                      normalize_features=True, topk=6)
    calls = []
    real = pmesh.make_retrieval_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmesh, "make_retrieval_mesh",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        get_similar.main([
            "--gallery_data", tout, "--topk", "6", "--device", "cpu",
            "--normalize_features", *OPTS, "MODEL.PRETRAIN_PATH", pth,
            "DATASETS.ROOT_DIR", queries, "OUTPUT_DIR", tres,
            "TPU.SHARDED_RETRIEVAL", "True", "SOLVER.DISTANCE_FUNC", dist])
    assert calls == [1]
    ref = np.load(f"{jres}/results.npy", allow_pickle=True).item()
    got = np.load(f"{tres}/results.npy", allow_pickle=True).item()
    q = np.load(f"{jres}/query_embeddings.npy")
    g = np.load(f"{jout}/embeddings.npy")
    q, g = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (q, g))
    assert list(got) == list(ref)
    for qp in ref:
        np.testing.assert_array_equal(got[qp]["indices"], ref[qp]["indices"])
        np.testing.assert_array_equal(got[qp]["paths"], ref[qp]["paths"])
        np.testing.assert_allclose(got[qp]["distances"],
                                   ref[qp]["distances"], rtol=0,
                                   atol=1e-4 * _scale(q, g))


def test_get_similar_sharded_at_topk_0_warns(cli_setup, flat_index,
                                             eight_cpus, caplog):
    """``--topk 0`` ranks every gallery entry, which no sharded top-k
    avoids: a warning, then the materialising path, as in the reference."""
    from centroids_reid_tpu_torch.inference import find_similar

    pth, _, queries, tmp = cli_setup
    cfg = _cfg(get_default_cfg, pth, queries, str(tmp / "sh_topk0"))
    cfg.TPU.SHARDED_RETRIEVAL = True
    with caplog.at_level("WARNING"):
        out = find_similar(cfg, flat_index[1], False, True, 0, device="cpu")
    assert "requires --topk > 0" in caplog.text
    assert all(len(r["indices"]) == 15 for r in out.values())


def test_server_built_with_sharded_retrieval_matches_jax(cli_setup,
                                                         flat_index,
                                                         eight_cpus):
    """``build_from_args`` with ``TPU.SHARDED_RETRIEVAL``: both services
    shard the index over 8 devices and answer the query images alike."""
    from centroids_reid_tpu.inference import server as jserver
    from centroids_reid_tpu_torch.inference import server as pserver

    pth, _, queries, _ = cli_setup
    jout, tout = flat_index
    argv = ["--port", "0", "--topk", "4", "--normalize_features",
            "--fp32_exact", *OPTS, "MODEL.PRETRAIN_PATH", pth,
            "TPU.SHARDED_RETRIEVAL", "True"]
    ref = jserver.build_from_args(["--gallery_data", jout, *argv])
    got = pserver.build_from_args(["--gallery_data", tout, "--device", "cpu",
                                   *argv])
    try:
        assert ref.service.mesh is not None
        assert got.service.mesh.shape == {"gallery": 8}
        files = sorted(os.path.join(queries, f) for f in os.listdir(queries))
        rd, ri, rp = ref.service.query_files(files)
        d, i, p = got.service.query_files(files)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(p, rp)
        # unit rows (--normalize_features): the scale is 2
        np.testing.assert_allclose(d, rd, rtol=0, atol=2e-4)
    finally:
        ref.shutdown()
        got.shutdown()
