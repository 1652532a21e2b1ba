"""The offline CLIs' flows: ``build_embeddings`` and ``find_similar``
through the port and through the JAX package on one image folder and one
reference-format ``.pth`` (resnet18, 32x16 JPEGs, fp32), on the CPU.

Tolerances: embeddings differ only by the fp32 conv / reduction order
(1e-4). A squared distance ``||q||^2 + ||g||^2 - 2 q.g`` carries that
error at the scale of the squared norms, so distances agree within 1e-4
of ``max ||q||^2 + max ||g||^2``. The rankings agree, so the indices and
paths in ``results.npy`` must be equal, and the files keep the
reference's schema."""

import numpy as np
import pytest
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu_torch.config import get_default_cfg
from test_torch_eval import write_reference_pth


def _write_folder(root, n_pids=5, per_pid=3, hw=(32, 16), seed=0):
    """Gallery images in pid subfolders, queries in one flat folder."""
    rng = np.random.RandomState(seed)
    colors = rng.randint(40, 215, (n_pids, 3))

    def img(pid):
        arr = colors[pid] + rng.randint(-40, 41, (1, 1, 3)) \
            + rng.randint(-20, 20, (*hw, 3))
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))

    for pid in range(n_pids):
        (root / "gallery" / f"{pid:03d}").mkdir(parents=True)
        for i in range(per_pid):
            img(pid).save(root / "gallery" / f"{pid:03d}" / f"img_{i:02d}.jpg")
    (root / "queries").mkdir()
    for j in range(7):
        img(j % n_pids).save(root / "queries" / f"q{j:02d}.jpg")
    return str(root / "gallery"), str(root / "queries")


def _cfg(make_cfg, pth, images, out, centroids=False):
    cfg = make_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [32, 16]
    cfg.TEST.IMS_PER_BATCH = 8
    cfg.MODEL.PRETRAIN_PATH = pth
    cfg.MODEL.USE_CENTROIDS = centroids
    cfg.DATASETS.ROOT_DIR = images
    cfg.OUTPUT_DIR = out
    return cfg


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    pth = write_reference_pth(tmp / "reid.pth", seed=2)
    gallery, queries = _write_folder(tmp)
    return pth, gallery, queries, tmp


def _index_both(cli_setup, centroids):
    """``build_embeddings`` through both packages; returns their output
    directories (JAX, port)."""
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import create_embeddings

    pth, gallery, _, tmp = cli_setup
    tag = "cent" if centroids else "flat"
    jout, tout = str(tmp / f"jax_{tag}"), str(tmp / f"port_{tag}")
    japi.build_embeddings(_cfg(jax_default_cfg, pth, gallery, jout,
                               centroids), images_in_subfolders=True)
    create_embeddings.main([
        "--images-in-subfolders", "--device", "cpu", "MODEL.NAME",
        "resnet18", "MODEL.BACKBONE_EMB_SIZE", "512",
        "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TEST", "[32,16]",
        "TEST.IMS_PER_BATCH", "8", "MODEL.PRETRAIN_PATH", pth,
        "MODEL.USE_CENTROIDS", str(centroids), "DATASETS.ROOT_DIR", gallery,
        "OUTPUT_DIR", tout,
    ])
    return jout, tout


@pytest.fixture(scope="module")
def flat_index(cli_setup):
    return _index_both(cli_setup, False)


@pytest.mark.parametrize("centroids", [False, True])
def test_build_embeddings_matches_jax(cli_setup, flat_index, centroids):
    jout, tout = (_index_both(cli_setup, True) if centroids else flat_index)
    ref_e = np.load(f"{jout}/embeddings.npy")
    ref_p = np.load(f"{jout}/paths.npy")
    got_e = np.load(f"{tout}/embeddings.npy")
    got_p = np.load(f"{tout}/paths.npy")
    assert got_e.dtype == ref_e.dtype == np.float32
    assert got_p.dtype == ref_p.dtype and got_e.shape == ref_e.shape
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_allclose(got_e, ref_e, rtol=1e-4, atol=1e-4)
    assert len(got_p) == (5 if centroids else 15)


@pytest.mark.parametrize("topk,normalize", [(4, False), (100, True),
                                            (0, False)])
def test_find_similar_matches_jax(cli_setup, flat_index, topk, normalize):
    """``--topk`` > 0 runs the exact fp32 top-k (K3's plain version here);
    ``--topk 0`` the full distance matrix and a stable argsort."""
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import get_similar

    pth, _, queries, tmp = cli_setup
    jout = flat_index[0]
    jres, tres = str(tmp / f"jres{topk}"), str(tmp / f"tres{topk}")
    japi.find_similar(_cfg(jax_default_cfg, pth, queries, jres), jout,
                      images_in_subfolders=False,
                      normalize_features=normalize, topk=topk)
    argv = ["--gallery_data", jout, "--topk", str(topk), "--device", "cpu",
            "MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE", "512",
            "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TEST", "[32,16]",
            "TEST.IMS_PER_BATCH", "8", "MODEL.PRETRAIN_PATH", pth,
            "DATASETS.ROOT_DIR", queries, "OUTPUT_DIR", tres]
    if normalize:
        argv.insert(0, "--normalize_features")
    get_similar.main(argv)

    ref = np.load(f"{jres}/results.npy", allow_pickle=True).item()
    got = np.load(f"{tres}/results.npy", allow_pickle=True).item()
    q, g = (np.load(f"{jres}/query_embeddings.npy"),
            np.load(f"{jout}/embeddings.npy"))
    if normalize:
        q, g = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (q, g))
    scale = (q * q).sum(axis=1).max() + (g * g).sum(axis=1).max()
    assert list(got) == list(ref)
    for qp in ref:
        assert sorted(got[qp]) == sorted(ref[qp]) == ["distances", "indices",
                                                      "paths"]
        np.testing.assert_array_equal(got[qp]["indices"], ref[qp]["indices"])
        np.testing.assert_array_equal(got[qp]["paths"], ref[qp]["paths"])
        np.testing.assert_allclose(got[qp]["distances"],
                                   ref[qp]["distances"], rtol=0,
                                   atol=1e-4 * scale)
        assert got[qp]["distances"].dtype == ref[qp]["distances"].dtype
        assert len(got[qp]["indices"]) == min(topk or 15, 15)
    np.testing.assert_allclose(np.load(f"{tres}/query_embeddings.npy"),
                               np.load(f"{jres}/query_embeddings.npy"),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.load(f"{tres}/query_paths.npy"),
                                  np.load(f"{jres}/query_paths.npy"))


@pytest.mark.parametrize("flag", ["RERANK", "SHARDED_RETRIEVAL"])
def test_find_similar_refuses_unported_options(cli_setup, flat_index, flag,
                                               caplog):
    """Nothing is refused. ``TPU.SHARDED_RETRIEVAL`` on one device (the
    CPU here) warns, as the reference does with fewer than two devices,
    and ranks on a one-device mesh: the results equal the unsharded
    run's (distances within 1e-5 of the squared norms' scale). With
    ``TPU.RERANK`` the reference routes to the re-ranker
    before it reads the sharding flag, so the two together re-rank."""
    from centroids_reid_tpu_torch.inference import find_similar

    pth, _, queries, tmp = cli_setup
    cfg = _cfg(get_default_cfg, pth, queries, str(tmp / f"refused_{flag}"))
    setattr(cfg.TPU, flag, True)
    if flag == "SHARDED_RETRIEVAL":
        with caplog.at_level("WARNING"):
            out = find_similar(cfg, flat_index[1], False, False, 5,
                               device="cpu")
        assert "needs >= 2 devices; using one" in caplog.text
        cfg.TPU.SHARDED_RETRIEVAL = False
        cfg.OUTPUT_DIR = str(tmp / "unsharded")
        ref = find_similar(cfg, flat_index[1], False, False, 5, device="cpu")
        q = np.load(tmp / "unsharded" / "query_embeddings.npy")
        g = np.load(f"{flat_index[1]}/embeddings.npy")
        scale = (q * q).sum(axis=1).max() + (g * g).sum(axis=1).max()
        for qp, r in ref.items():
            np.testing.assert_array_equal(out[qp]["indices"], r["indices"])
            # the same fp32 formula over another matmul blocking: rounding
            # at the scale of the squared norms
            np.testing.assert_allclose(out[qp]["distances"],
                                       r["distances"], rtol=0,
                                       atol=1e-5 * scale)
        return
    cfg.TPU.SHARDED_RETRIEVAL = True
    out = find_similar(cfg, flat_index[1], False, False, 5, device="cpu")
    assert len(out) == 7 and all(len(r["indices"]) == 5
                                 for r in out.values())


@pytest.mark.parametrize("window,topk", [(0, 6), (0, 0), (10, 6)],
                         ids=["dense", "dense-all", "windowed"])
def test_find_similar_rerank_matches_jax(cli_setup, flat_index, window,
                                         topk):
    """``TPU.RERANK True``: the fully re-ranked matrix (``--topk 0``: every
    gallery entry) or, with ``TPU.RERANK_WINDOW``, each query's top-r
    window re-ranked; ``results.npy`` as the JAX package's: indices and
    paths equal, re-rank scores within 1e-5 (the embeddings differ by the
    fp32 conv order only)."""
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import get_similar

    pth, _, queries, tmp = cli_setup
    jout = flat_index[0]
    tag = f"rr{window}_{topk}"
    jres, tres = str(tmp / f"j{tag}"), str(tmp / f"t{tag}")
    opts = ["TPU.RERANK", "True", "TPU.RERANK_WINDOW", str(window),
            "TPU.RERANK_K1", "6", "TPU.RERANK_K2", "3"]
    jcfg = _cfg(jax_default_cfg, pth, queries, jres)
    jcfg.merge_from_list(opts)
    japi.find_similar(jcfg, jout, images_in_subfolders=False,
                      normalize_features=True, topk=topk)
    get_similar.main([
        "--gallery_data", jout, "--topk", str(topk), "--device", "cpu",
        "--normalize_features", "MODEL.NAME", "resnet18",
        "MODEL.BACKBONE_EMB_SIZE", "512", "USE_MIXED_PRECISION", "False",
        "INPUT.SIZE_TEST", "[32,16]", "TEST.IMS_PER_BATCH", "8",
        "MODEL.PRETRAIN_PATH", pth, "DATASETS.ROOT_DIR", queries,
        "OUTPUT_DIR", tres, *opts])
    ref = np.load(f"{jres}/results.npy", allow_pickle=True).item()
    got = np.load(f"{tres}/results.npy", allow_pickle=True).item()
    assert list(got) == list(ref)
    for qp in ref:
        np.testing.assert_array_equal(got[qp]["indices"], ref[qp]["indices"])
        np.testing.assert_array_equal(got[qp]["paths"], ref[qp]["paths"])
        np.testing.assert_allclose(got[qp]["distances"],
                                   ref[qp]["distances"], rtol=0, atol=1e-5)
        assert len(got[qp]["indices"]) == (topk or 15)
