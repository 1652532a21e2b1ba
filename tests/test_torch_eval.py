"""The evaluation slice: ONLY_TEST through the port's runner and the JAX
package's ``run_single`` on one reference-format ``.pth`` and one
Market-1501-layout dataset (resnet18, 32x16 JPEGs, fp32), on the CPU.

Tolerances: the embeddings differ only by the fp32 conv/reduction order
(1e-4); the rankings then agree, so Top-k must be equal and mAP within
1e-6 (fp32 summation order), with and without centroids. The int8
evaluation has its own bound, stated in its test."""

import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.models import from_jax_params
from torch_oracle import randomize_params, randomize_stats


def write_market(root, n_pids=6, hw=(32, 16), seed=0):
    """A Market-1501 layout: each pid a base colour with a per-image shift
    and pixel noise (so mAP is not pinned at 1.0); queries on camera 1 and
    2, gallery on cameras 2-6, a few train images."""
    base = root / "market1501"
    rng = np.random.RandomState(seed)
    colors = rng.randint(40, 215, (n_pids, 3))
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        (base / sub).mkdir(parents=True)

    def write(subdir, pid, camid, i):
        shift = rng.randint(-45, 46, (1, 1, 3))
        arr = np.clip(colors[pid] + shift
                      + rng.randint(-20, 20, (*hw, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(
            base / subdir / f"{pid + 1:04d}_c{camid}s1_{i:06d}_00.jpg")

    for pid in range(n_pids):
        write("bounding_box_train", pid, 1, 0)
        for i in range(2):
            write("query", pid, 1 + i, 100 + i)
        for i in range(5):
            write("bounding_box_test", pid, 2 + i % 5, 200 + i)
    return str(root)


def write_separable_market(root, n_pids=6, hw=(32, 16), seed=0):
    """A Market-1501 layout whose identities are random 4x2 block patterns
    under +-3 pixel noise, so each identity is a tight cluster far from the
    others. The last gallery image of each pid shows a pattern of no pid,
    which keeps the plain mAP below 1."""
    base = root / "market1501"
    rng = np.random.RandomState(seed)
    patterns = rng.randint(0, 256, (2 * n_pids, 4, 2, 3)).astype(np.float32)
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        (base / sub).mkdir(parents=True)

    def write(subdir, pattern, pid, camid, i):
        arr = np.kron(pattern, np.ones((hw[0] // 4, hw[1] // 2, 1)))
        arr = np.clip(arr + rng.randint(-3, 4, (*hw, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(
            base / subdir / f"{pid + 1:04d}_c{camid}s1_{i:06d}_00.jpg")

    for pid in range(n_pids):
        write("bounding_box_train", patterns[pid], pid, 1, 0)
        for i in range(2):
            write("query", patterns[pid], pid, 1 + i, 100 + i)
        for i in range(5):
            pattern = patterns[n_pids + pid] if i == 4 else patterns[pid]
            write("bounding_box_test", pattern, pid, 2 + i, 200 + i)
    return str(root)


def write_reference_pth(path, seed=0):
    """Random resnet18 weights (JAX init, randomised) saved in the
    reference checkpoint format."""
    import jax
    import jax.numpy as jnp

    from centroids_reid_tpu.models import create_model

    cfg = jax_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    model = create_model(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 32, 16, 3)))
    params = randomize_params(jax.tree.map(np.asarray, v["params"]), seed)
    stats = randomize_stats(jax.tree.map(np.asarray, v["batch_stats"]), 1)
    torch.save({"state_dict": from_jax_params(params, stats)}, path)
    return str(path)


def small_cfg(make_cfg, pth, data_root, log_dir):
    cfg = make_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [32, 16]
    cfg.TEST.IMS_PER_BATCH = 16
    cfg.TEST.ONLY_TEST = True
    cfg.MODEL.PRETRAIN_PATH = pth
    cfg.MODEL.USE_CENTROIDS = True
    cfg.DATASETS.NAMES = "market1501"
    cfg.DATASETS.ROOT_DIR = data_root
    cfg.LOG_DIR = log_dir
    return cfg


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    return (write_reference_pth(tmp / "reid.pth"),
            write_market(tmp / "data"), tmp)


def test_only_test_matches_jax(eval_setup):
    """Both centroid modes (camera-aware centroids first, then plain), the
    same metric keys, equal Top-k, mAP within 1e-6."""
    from centroids_reid_tpu.engine import runner as jrunner
    from centroids_reid_tpu_torch.engine import runner

    pth, data, tmp = eval_setup
    ref = jrunner.run_single(
        small_cfg(jax_default_cfg, pth, data, str(tmp / "jax_logs")),
        "ctl", "test")
    got = runner.run_single(
        small_cfg(get_default_cfg, pth, data, str(tmp / "port_logs")),
        "ctl", "test", device="cpu")
    assert sorted(got) == sorted(ref)
    for key in ref:
        if "mAP" in key:
            assert abs(got[key] - ref[key]) <= 1e-6, key
        else:
            assert got[key] == ref[key], key
    assert 0.3 < ref["test_plain_mAP"] < 1.0   # not a saturated metric
    assert (tmp / "port_logs" / "test" / "version_0" / "test"
            / "metrics.jsonl").exists()


def test_extracted_embeddings_match_jax(eval_setup):
    """The val-set embeddings of both packages, and the centroid eval set
    built from them, agree within 1e-4."""
    from centroids_reid_tpu.data import EvalLoader as JEvalLoader
    from centroids_reid_tpu.data import init_dataset as jinit
    from centroids_reid_tpu.engine import evaluate as jevaluate
    from centroids_reid_tpu.engine.runner import load_model_for_test
    from centroids_reid_tpu_torch.data import EvalLoader, init_dataset
    from centroids_reid_tpu_torch.engine import evaluate
    from centroids_reid_tpu_torch.engine.runner import (
        load_model_for_test as port_load,
    )

    pth, data, tmp = eval_setup
    jcfg = small_cfg(jax_default_cfg, pth, data, str(tmp / "j"))
    jds = jinit("market1501", jcfg)
    jmodel, params, stats = load_model_for_test(jcfg, jds)
    ref = jevaluate.extract_embeddings(jmodel, jcfg, params, stats,
                                       JEvalLoader(jds.val, jcfg))
    cfg = small_cfg(get_default_cfg, pth, data, str(tmp / "t"))
    ds = init_dataset("market1501", cfg)
    got = evaluate.extract_embeddings(port_load(cfg, "cpu"), cfg,
                                      EvalLoader(ds.val, cfg))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


def test_only_test_int8_eval_matches_jax(eval_setup):
    """``TPU.INT8_EVAL``: both packages calibrate on the same leading val
    batches and embed with the reference's serving engine (unfused convs,
    bf16 accumulator). XLA's CPU program fuses the epilogue into an fma and
    skips the bf16 accumulator rounding (ROADMAP.md queue 3), so the int8
    embeddings agree to cosine ~0.998, not bit for bit. On a set of tight,
    well-separated identity clusters Top-k must be equal; mAP within 1e-2,
    since the out-of-place gallery images lie nearly equidistant from the
    other clusters and may move a rank or two among them."""
    from centroids_reid_tpu.engine import runner as jrunner
    from centroids_reid_tpu_torch.engine import runner

    pth, _, tmp = eval_setup
    data = write_separable_market(tmp / "separable")
    cfgs = []
    for make_cfg, logs in ((jax_default_cfg, "jax_int8"),
                           (get_default_cfg, "port_int8")):
        cfg = small_cfg(make_cfg, pth, data, str(tmp / logs))
        cfg.TPU.INT8_EVAL = True
        cfg.TPU.INT8_CALIB_BATCHES = 2
        cfgs.append(cfg)
    ref = jrunner.run_single(cfgs[0], "ctl", "test")
    got = runner.run_single(cfgs[1], "ctl", "test", device="cpu")
    assert sorted(got) == sorted(ref)
    for key in ref:
        if "mAP" in key:
            assert abs(got[key] - ref[key]) <= 1e-2, key
        else:
            assert got[key] == ref[key], key
    assert 0.5 < ref["test_plain_mAP"] < 1.0


def test_only_test_int8_eval_reuses_its_artifact(eval_setup):
    """``TPU.INT8_EVAL``: the first run calibrates and saves the artifact at
    ``TPU.INT8_CACHE_PATH``, the second loads it (same identity) and gives
    the same metrics; a changed calibration setting recalibrates."""
    from centroids_reid_tpu_torch.engine import runner
    from centroids_reid_tpu_torch.models import quantized

    pth, data, tmp = eval_setup
    cfg = small_cfg(get_default_cfg, pth, data, str(tmp / "int8_logs"))
    cfg.TPU.INT8_EVAL = True
    cfg.TPU.INT8_CALIB_BATCHES = 1
    cfg.TPU.INT8_CACHE_PATH = str(tmp / "int8" / "reid")
    first = runner.run_single(cfg, "ctl", "test", device="cpu")
    art = tmp / "int8" / "reid.npz"
    assert art.exists()
    stamp = art.stat().st_mtime_ns
    second = runner.run_single(cfg, "ctl", "test", device="cpu")
    assert second == first and art.stat().st_mtime_ns == stamp
    loaded = quantized.QuantizedEmbed.load(str(art), device="cpu")
    assert loaded.extra_meta["calib_batches"] == 1
    cfg.TPU.INT8_CALIB_PCT = 99.9
    runner.run_single(cfg, "ctl", "test", device="cpu")
    assert art.stat().st_mtime_ns != stamp
    assert all(np.isfinite(v) for v in first.values())


@pytest.mark.parametrize("opt,value,match", [
    ("TEST.ONLY_TEST", False, "training"),
    ("TPU.RERANK", True, "RERANK"),
])
def test_runner_refuses_unported_routes(eval_setup, opt, value, match):
    from centroids_reid_tpu_torch.engine import runner

    pth, data, tmp = eval_setup
    cfg = small_cfg(get_default_cfg, pth, data, str(tmp / "refused"))
    section, key = opt.split(".")
    setattr(getattr(cfg, section), key, value)
    error = NotImplementedError
    if opt == "TEST.ONLY_TEST":
        # training is ported at any TPU.NUM_GROUPS; a matmul precision
        # that cuBLAS / cuDNN cannot compute (bf16_3x) is refused
        cfg.TPU.MATMUL_PRECISION = "high"
        error = ValueError
    else:
        # full and windowed re-ranking are ported; windowed re-ranking
        # with rank visualisation is the reference's startup ValueError
        cfg.TPU.RERANK_WINDOW = 50
        cfg.TEST.VISUALIZE = "yes"
        error = ValueError
    with pytest.raises(error, match=match):
        runner.run_single(cfg, "ctl", "test", device="cpu")


def test_only_test_rerank_matches_jax(eval_setup):
    """``TPU.RERANK True``: both centroid modes evaluate on the fully
    re-ranked distances; Top-k equal, mAP within 1e-6."""
    from centroids_reid_tpu.engine import runner as jrunner
    from centroids_reid_tpu_torch.engine import runner

    pth, data, tmp = eval_setup
    cfgs = []
    for make_cfg, logs in ((jax_default_cfg, "jax_rerank"),
                           (get_default_cfg, "port_rerank")):
        cfg = small_cfg(make_cfg, pth, data, str(tmp / logs))
        cfg.TPU.RERANK = True
        cfg.TPU.RERANK_K1 = 6
        cfg.TPU.RERANK_K2 = 3
        cfgs.append(cfg)
    ref = jrunner.run_single(cfgs[0], "ctl", "test")
    got = runner.run_single(cfgs[1], "ctl", "test", device="cpu")
    assert sorted(got) == sorted(ref)
    for key in ref:
        if "mAP" in key:
            assert abs(got[key] - ref[key]) <= 1e-6, key
        else:
            assert got[key] == ref[key], key


def test_validate_rerank_config_refuses_what_evaluation_cannot_do(
        eval_setup, monkeypatch):
    """At startup: full re-ranking of an eval set past the guard raises
    the reference's ValueError (with and without centroids, counted
    exactly), and so does windowed re-ranking with ``TEST.VISUALIZE``;
    windowed re-ranking alone passes at any size; without ``TPU.RERANK``
    nothing is checked."""
    from centroids_reid_tpu.data import init_dataset as jinit
    from centroids_reid_tpu.engine import evaluate as jevaluate
    from centroids_reid_tpu.ops import rerank as jrerank
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import evaluate
    from centroids_reid_tpu_torch.ops import rerank

    pth, data, tmp = eval_setup
    cfg = small_cfg(get_default_cfg, pth, data, str(tmp / "v"))
    ds = init_dataset("market1501", cfg)
    jcfg = small_cfg(jax_default_cfg, pth, data, str(tmp / "jv"))
    jds = jinit("market1501", jcfg)
    evaluate.validate_rerank_config(cfg, ds)
    cfg.TPU.RERANK = jcfg.TPU.RERANK = True
    evaluate.validate_rerank_config(cfg, ds)   # 42 rows: within the guard
    for keep in (False, True):
        cfg.MODEL.KEEP_CAMID_CENTROIDS = keep
        jcfg.MODEL.KEEP_CAMID_CENTROIDS = keep
        n = ds.num_query + evaluate._centroid_gallery_rows(
            [r.pid for r in ds.val[ds.num_query:]],
            [r.camid for r in ds.val[ds.num_query:]],
            [r.pid for r in ds.val[:ds.num_query]],
            [r.camid for r in ds.val[:ds.num_query]], keep)
        monkeypatch.setattr(rerank, "DEFAULT_MAX_N", n)
        monkeypatch.setattr(jrerank, "DEFAULT_MAX_N", n)
        with pytest.raises(ValueError) as port:
            evaluate.validate_rerank_config(cfg, ds)
        with pytest.raises(ValueError) as ref:
            jevaluate.validate_rerank_config(jcfg, jds)
        assert str(port.value) == str(ref.value)
        assert "plain eval N=42" in str(port.value)
    cfg.TPU.RERANK_WINDOW = jcfg.TPU.RERANK_WINDOW = 50
    evaluate.validate_rerank_config(cfg, ds)
    cfg.TEST.VISUALIZE = jcfg.TEST.VISUALIZE = "yes"
    with pytest.raises(ValueError) as port:
        evaluate.validate_rerank_config(cfg, ds)
    with pytest.raises(ValueError) as ref:
        jevaluate.validate_rerank_config(jcfg, jds)
    assert str(port.value) == str(ref.value)


def test_runner_main_parses_the_training_cli_flags(eval_setup, tmp_path):
    """``main`` takes ``--config_file`` plus KEY VALUE opts, as
    train_ctl_model.py does, and ``--device``."""
    from centroids_reid_tpu_torch.engine import runner

    pth, data, _ = eval_setup
    out = runner.main([
        "--device", "cpu", "MODEL.NAME", "resnet18",
        "MODEL.BACKBONE_EMB_SIZE", "512", "USE_MIXED_PRECISION", "False",
        "INPUT.SIZE_TEST", "[32,16]", "TEST.ONLY_TEST", "True",
        "MODEL.PRETRAIN_PATH", pth, "DATASETS.ROOT_DIR", data,
        "OUTPUT_DIR", str(tmp_path / "out"), "MODEL.USE_CENTROIDS", "False",
    ])
    assert set(out) >= {"test_plain_mAP", "test_centroids_mAP",
                        "test_plain_Top-1"}
    assert (tmp_path / "out" / "train_ctl_model" / "version_0"
            / "config.yml").exists()
