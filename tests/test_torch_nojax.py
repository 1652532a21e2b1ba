"""The port stands without JAX and without the JAX package: importing it,
serving a query on the CPU through the bf16 path, the fast ingest (packed
YUV420) and the int8 path (PTQ embed + int8 gallery), a re-ranked service
behind the HTTP server answering one /search, a streaming evaluation, an
ONLY_TEST evaluation through its runner (also re-ranked, fully and in
windows, and with its rank visualisation), a one-epoch training run and its
resume, the offline CLIs' flows (``find_similar`` also re-ranked), a
query on a gallery sharded over a 4-shard CPU mesh and a sharded ``R1mAP``,
the serving artifacts (an embedder and a retriever exported, saved, loaded and
queried, and ``python -m ...inference.export_model`` run), and
importing ``chip_smoke`` load neither jax nor flax nor optax nor orbax nor
any module of ``centroids_reid_tpu``; nor does the fashion recipe
(``configs/320_resnet50_ibn_a.yml``: ResNet50-IBN-a over a COCO-layout
``df1`` split, one epoch, ONLY_TEST, ``evaluate_on_train`` and the int8
IBN embed); an orbax checkpoint of the JAX
package loads, serves and resumes while jax, orbax and tensorstore are
blocked from import; a 2-process ``fit`` and a 2-process sharded
extraction over ``torch.distributed`` (gloo) run while jax, flax, optax,
orbax, tensorstore and the JAX package are blocked; no source file of the
port (``parallel/`` included) imports the JAX package; and the service
refuses what the reference refuses."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import cpu_subprocess_env

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import base64, io, json, os, runpy, sys, tempfile, urllib.request
    import numpy as np
    import torch
    from PIL import Image
    import centroids_reid_tpu_torch
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine import runner
    from centroids_reid_tpu_torch.inference import (
        RetrievalService, build_embeddings, find_similar)
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.inference.export import (
        export_embedder, export_retriever, load_embedder, load_retriever,
        save_artifact)
    from centroids_reid_tpu_torch.inference.server import RetrievalHTTPServer
    from centroids_reid_tpu_torch.metrics import R1mAP
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model
    from centroids_reid_tpu_torch.ops import rerank_distmat, rerank_topk
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh
    import chip_smoke

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.INPUT.SIZE_TEST = [32, 16]
    rng = np.random.RandomState(0)
    gallery = rng.randn(40, 512).astype(np.float32)
    model = create_model(cfg)
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model)
    img = rng.randint(0, 256, (32, 16, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    d, idx, _ = svc.query_bytes([buf.getvalue()])
    assert d.shape == (1, 3) and np.isfinite(d).all(), d
    cfg.TPU.FAST_DECODE = True
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model)
    assert svc.ingest_format == "yuv420", svc.ingest_format
    assert svc.ingest_bytes([buf.getvalue()]).shape == (1, 32 * 16 * 3 // 2)
    d, idx, _ = svc.query_bytes([buf.getvalue()])
    assert d.shape == (1, 3) and np.isfinite(d).all(), d
    cfg.TPU.FAST_DECODE = False
    m = R1mAP(8, streaming=True, device="cpu").compute(
        gallery, np.arange(40) % 5, np.arange(40) % 2)
    assert 0.0 <= m.mAP <= 1.0, m
    mesh = make_retrieval_mesh(devices=["cpu"] * 4)
    m_sh = R1mAP(8, streaming=True, mesh=mesh).compute(
        gallery, np.arange(40) % 5, np.arange(40) % 2)
    assert m_sh.mAP == m.mAP, (m_sh, m)
    kw = dict(k=3, model=model, use_bf16_kernel=False)
    _, idx_sh, _ = RetrievalService(
        cfg, gallery, [str(i) for i in range(40)], mesh=mesh,
        **kw).query_bytes([buf.getvalue()])
    _, idx, _ = RetrievalService(
        cfg, gallery, [str(i) for i in range(40)], device="cpu",
        **kw).query_bytes([buf.getvalue()])
    assert (idx_sh == idx).all(), (idx_sh, idx)
    qfn = quantize_reid_model(model, [img[None]], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD, use_pallas=True)
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model, int8_qfn=qfn,
                           use_int8_gallery=True)
    d, idx, _ = svc.query_bytes([buf.getvalue()])
    assert d.shape == (1, 3) and np.isfinite(d).all(), d
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model, rerank_window=10)
    server = RetrievalHTTPServer(svc, port=0, batch_window_ms=1.0)
    server.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/search",
            data=json.dumps({"images_b64": [
                base64.b64encode(buf.getvalue()).decode()]}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            res = json.loads(r.read())["results"][0]
    finally:
        server.shutdown()
    assert len(res["indices"]) == 3 and server.health()["rerank_window"] == 10
    d, i = rerank_topk(gallery[:4], gallery, r=10, device="cpu")
    assert d.shape == (4, 10) and (i[:, 0].numpy() == range(4)).all(), i
    assert rerank_distmat(gallery[:4], gallery, device="cpu").shape == (4, 40)

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "reid.pth")
        torch.save({"state_dict": model.state_dict()}, pth)
        base = os.path.join(tmp, "data", "market1501")
        for sub, cams in (("bounding_box_train", (1, 2)), ("query", (1,)),
                          ("bounding_box_test", (2, 3))):
            os.makedirs(os.path.join(base, sub))
            for pid in range(3):
                for cam in cams:
                    Image.fromarray(rng.randint(0, 256, (32, 16, 3)).astype(
                        np.uint8)).save(os.path.join(
                            base, sub, f"{pid + 1:04d}_c{cam}s1_000000_00.jpg"))
        cfg.USE_MIXED_PRECISION = False
        cfg.TEST.ONLY_TEST = True
        cfg.MODEL.PRETRAIN_PATH = pth
        cfg.DATASETS.ROOT_DIR = os.path.join(tmp, "data")
        cfg.LOG_DIR = os.path.join(tmp, "logs")
        art = os.path.join(tmp, "embedder.crt")
        blobs, meta = export_embedder(model, cfg, platforms=("cpu",))
        save_artifact(art, blobs, meta)
        e = load_embedder(art, "cpu").embed(img[None])
        assert e.shape == (1, 512) and np.isfinite(e).all(), e
        blobs, meta, aux = export_retriever(
            model, cfg, gallery, [str(i) for i in range(40)], k=3,
            batch_size=2, platforms=("cpu",))
        save_artifact(art, blobs, meta, aux=aux)
        d, idx, _ = load_retriever(art, "cpu").query_bytes([buf.getvalue()])
        assert d.shape == (1, 3) and np.isfinite(d).all(), d
        argv = sys.argv
        sys.argv = ["export_model", "--output", art, "--platforms", "cpu",
                    "--device", "cpu", "MODEL.NAME", "resnet18",
                    "INPUT.SIZE_TEST", "[32,16]", "USE_MIXED_PRECISION",
                    "False", "MODEL.PRETRAIN_PATH", pth]
        try:
            runpy.run_module("centroids_reid_tpu_torch.inference.export_model",
                             run_name="__main__")
        finally:
            sys.argv = argv
        assert load_embedder(art, "cpu").embed(img[None]).shape == (1, 512)
        out = runner.run_single(cfg, "ctl", "test", device="cpu")
        assert 0.0 <= out["test_plain_mAP"] <= 1.0, out
        cfg.TPU.RERANK = True
        out = runner.run_single(cfg, "ctl", "test", device="cpu")
        assert 0.0 <= out["test_plain_mAP"] <= 1.0, out
        cfg.TPU.RERANK_WINDOW = 2
        out = runner.run_single(cfg, "ctl", "test", device="cpu")
        assert 0.0 <= out["test_plain_mAP"] <= 1.0, out
        cfg.TPU.RERANK = False
        cfg.TPU.RERANK_WINDOW = 0
        cfg.TEST.VISUALIZE = "yes"
        cfg.OUTPUT_DIR = os.path.join(tmp, "vis")
        runner.run_single(cfg, "ctl", "test", device="cpu")
        pngs = os.listdir(os.path.join(tmp, "vis", "visrank"))
        assert len(pngs) == 3 and all(p.endswith(".png") for p in pngs), pngs
        cfg.TEST.VISUALIZE = "no"
        cfg.TEST.ONLY_TEST = False
        cfg.MODEL.PRETRAINED = False
        cfg.INPUT.SIZE_TRAIN = [32, 16]
        cfg.SOLVER.IMS_PER_BATCH = 2
        cfg.SOLVER.MAX_EPOCHS = 1
        cfg.DATALOADER.USE_RESAMPLING = False
        out = runner.run_single(cfg, "ctl", "train", device="cpu")
        assert "test_centroids_mAP" in out, out
        cfg.MODEL.RESUME_TRAINING = True
        cfg.MODEL.PRETRAIN_PATH = os.path.join(
            cfg.LOG_DIR, "train", "version_0", "auto_checkpoints",
            "checkpoint_epoch0")
        cfg.SOLVER.MAX_EPOCHS = 2
        out = runner.run_single(cfg, "base", "train", device="cpu")
        assert "test_plain_mAP" in out, out
        cfg.MODEL.RESUME_TRAINING = False
        cfg.DATASETS.ROOT_DIR = os.path.join(base, "bounding_box_test")
        cfg.OUTPUT_DIR = os.path.join(tmp, "index")
        build_embeddings(cfg, False, device="cpu")
        cfg.DATASETS.ROOT_DIR = os.path.join(base, "query")
        cfg.OUTPUT_DIR = os.path.join(tmp, "results")
        res = find_similar(cfg, os.path.join(tmp, "index"), False, False, 2,
                           device="cpu")
        assert len(res) == 3 and all(len(r["indices"]) == 2
                                     for r in res.values()), res
        cfg.TPU.RERANK = True
        cfg.TPU.RERANK_WINDOW = 4
        res = find_similar(cfg, os.path.join(tmp, "index"), False, False, 2,
                           device="cpu")
        assert len(res) == 3 and all(len(r["indices"]) == 2
                                     for r in res.values()), res

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "orbax", "centroids_reid_tpu"))
    assert not bad, bad
    print("OK")
""")

def test_port_imports_and_serves_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT],
                          env=cpu_subprocess_env(), capture_output=True,
                          text=True, timeout=300, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_FASHION_SCRIPT = textwrap.dedent("""
    import json, os, sys, tempfile
    import numpy as np
    import torch
    from PIL import Image
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import evaluate_on_train, runner
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model

    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "images")
        for split, pairs in (("train", (7, 7, 9, 9)), ("query", (7, 9)),
                             ("gallery", (7, 7, 9, 9))):
            os.makedirs(os.path.join(root, split))
            images, anns = [], []
            for i, pair in enumerate(pairs):
                name = f"{split}_{i}.jpg"
                Image.fromarray(rng.randint(0, 256, (32, 32, 3)).astype(
                    np.uint8)).save(os.path.join(root, split, name))
                images.append({"id": i, "file_name": name})
                anns.append({"image_id": i, "pair_id": pair})
            with open(os.path.join(root, f"{split}_32_32.json"), "w") as f:
                json.dump({"images": images, "annotations": anns}, f)
        fcfg = get_default_cfg()
        fcfg.merge_from_file(os.path.join("configs",
                                          "320_resnet50_ibn_a.yml"))
        fcfg.merge_from_list([
            "DATASETS.NAMES", "df1", "DATASETS.ROOT_DIR", root,
            "DATASETS.JSON_TRAIN_PATH", os.path.join(root, "train_32_32.json"),
            "INPUT.SIZE_TRAIN", "[32,32]", "INPUT.SIZE_TEST", "[32,32]",
            "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_INSTANCE", "2",
            "MODEL.PRETRAINED", "False", "USE_MIXED_PRECISION", "False",
            "MODEL.KEEP_CAMID_CENTROIDS", "False", "MODEL.USE_CENTROIDS",
            "True", "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1",
            "DATALOADER.USE_RESAMPLING", "False"])
        fcfg.LOG_DIR = os.path.join(tmp, "logs")
        out = runner.run_single(fcfg, "ctl", "train", device="cpu")
        assert "test_centroids_mAP" in out, out
        ckpt = os.path.join(fcfg.LOG_DIR, "train", "version_0",
                            "checkpoints", "epoch=0")
        fcfg.TEST.ONLY_TEST = True
        fcfg.MODEL.PRETRAIN_PATH = ckpt
        out = runner.run_single(fcfg, "ctl", "test", device="cpu")
        assert 0.0 <= out["test_plain_mAP"] <= 1.0, out
        ibn = runner.load_model_for_test(fcfg, "cpu")
        out = evaluate_on_train(fcfg, ibn, init_dataset("df1", fcfg))
        assert 0.0 <= out["Train mAP"] <= 1.0, out
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        qfn = quantize_reid_model(ibn, [x], fcfg.INPUT.PIXEL_MEAN,
                                  fcfg.INPUT.PIXEL_STD, use_pallas=True)
        assert any(k.endswith(".pre") for k in qfn.qtree["act_scales"])
        e = qfn(x)
        assert e.shape == (2, 2048) and torch.isfinite(e).all(), e

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "orbax", "centroids_reid_tpu"))
    assert not bad, bad
    print("OK")
""")


def test_fashion_recipe_runs_without_jax():
    """``configs/320_resnet50_ibn_a.yml`` (ResNet50-IBN-a) over a
    COCO-layout ``df1`` split at 32x32: one epoch, ONLY_TEST,
    ``evaluate_on_train`` and the int8 IBN embed, in a subprocess that
    loads no JAX module."""
    proc = subprocess.run([sys.executable, "-c", _FASHION_SCRIPT],
                          env=cpu_subprocess_env(), capture_output=True,
                          text=True, timeout=300, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


_ORBAX_SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
               "zstandard", "centroids_reid_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine.checkpoint import restore_state
    from centroids_reid_tpu_torch.engine.orbax_read import read_checkpoint
    from centroids_reid_tpu_torch.engine.state import create_train_state
    from centroids_reid_tpu_torch.inference import load_inference_model
    from centroids_reid_tpu_torch.models import create_model

    fixture, ckpt = sys.argv[1:3]
    tree = read_checkpoint(fixture + "/checkpoint_epoch1")
    with np.load(fixture + "/arrays.npz") as z:
        for key in z.files:
            node = tree
            for part in key.split("."):
                node = node[int(part)] if isinstance(node, list) else node[
                    part]
            assert np.array_equal(node, z[key]), key
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [32, 16]
    cfg.MODEL.PRETRAIN_PATH = ckpt
    model = load_inference_model(cfg, "cpu")
    with torch.no_grad():
        e = model.embed(torch.zeros(2, 3, 32, 16))
    assert e.shape == (2, 512) and torch.isfinite(e).all()
    train = create_model(cfg, num_classes=6,
                         generator=torch.Generator().manual_seed(0))
    state = restore_state(ckpt, create_train_state(cfg, train, 6,
                                                   torch.Generator()))
    assert state.step == 1 and len(state.optimizers.model.state) > 0
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("OK")
""")


def test_orbax_checkpoints_load_with_jax_orbax_and_tensorstore_blocked(
        tmp_path):
    """The committed fixture and a JAX-written resnet18 checkpoint read,
    serve (``load_inference_model``) and resume (``restore_state``) in a
    process where importing jax, flax, optax, orbax, tensorstore, zstandard
    or the JAX package raises."""
    from test_torch_orbax import FIXTURE, write_jax_checkpoint

    ckpt, _ = write_jax_checkpoint(tmp_path, 6)
    proc = subprocess.run(
        [sys.executable, "-c", _ORBAX_SCRIPT, FIXTURE, ckpt],
        env=cpu_subprocess_env(), capture_output=True, text=True,
        timeout=300, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_two_process_flows_run_with_jax_blocked(tmp_path):
    """``tests/fixtures/torch_dist_worker.py`` with ``block_jax``: one epoch
    of ``fit`` over 2 ranks (G = 2, validation and checkpoints) and the
    sharded extraction over 2 ranks, each against the full extraction."""
    from fixtures.torch_dist_worker import start, wait
    from test_integration import _make_separable_market
    from test_torch_dist_fit import fit_opts

    root = _make_separable_market(tmp_path, n_pids=8, per_pid=4)
    env = cpu_subprocess_env()
    fit = start(tmp_path, {"task": "fit", "block_jax": True,
                           "log_dir": str(tmp_path / "run"),
                           "opts": fit_opts(root, 0, "SOLVER.MAX_EPOCHS",
                                            "1")}, 2, env)
    extract = start(tmp_path, {"task": "extract", "block_jax": True,
                               "opts": ["DATASETS.ROOT_DIR", root,
                                        "MODEL.NAME", "resnet18",
                                        "INPUT.SIZE_TEST", "[32,16]",
                                        "USE_MIXED_PRECISION", "False"]},
                    2, env)
    for out in wait(fit):
        assert np.isfinite(float(out["metric.test_centroids_mAP"]))
        assert int(out["jax_modules"]) == 0
    for out in wait(extract):
        np.testing.assert_allclose(out["emb"], out["ref_emb"], atol=1e-5)
        assert int(out["jax_modules"]) == 0
    assert os.listdir(tmp_path / "run" / "auto_checkpoints") == [
        "checkpoint_epoch0"]


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import) centroids_reid_tpu(\.| |$)", re.MULTILINE)


def test_no_source_of_the_port_imports_the_jax_package():
    """Not even lazily inside a function: every ``.py`` of the port and
    ``chip_smoke.py``."""
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO,
                                               "centroids_reid_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if _JAX_PACKAGE_IMPORT.search(f.read()):
                offenders.append(os.path.relpath(path, _REPO))
    assert len(files) > 20 and not offenders, offenders
    scanned = {os.path.relpath(p, _REPO) for p in files}
    for module in ("ops/rerank.py", "inference/server.py",
                   "inference/export.py", "inference/export_model.py",
                   "metrics/streaming_eval.py", "metrics/visrank.py",
                   "losses/triplet.py", "losses/centroid.py",
                   "losses/classification.py", "solver/build.py",
                   "data/sampler.py", "data/device_data.py",
                   "engine/steps.py", "engine/state.py",
                   "engine/epoch_runner.py", "engine/checkpoint.py",
                   "engine/fit.py", "utils/preemption.py",
                   "utils/profiling.py", "utils/seeding.py",
                   "parallel/mesh.py", "parallel/retrieval.py",
                   "engine/runner.py", "engine/evaluate.py",
                   "data/loader.py", "data/transforms.py"):
        assert f"centroids_reid_tpu_torch/{module}" in scanned, module


class _Int8EmbedStub:
    """Stands in for a QuantizedEmbed where the service is only built."""

    def to(self, device):
        return self


_CPU_MESH = ("cpu", "cpu")   # two shards on the CPU


@pytest.mark.parametrize("option,kwargs", [
    ("mesh", {"mesh": _CPU_MESH}),
    ("rerank_window", {"rerank_window": 20}),
    ("TPU.FAST_DECODE", {}),
    ("rerank_window", {"use_int8_gallery": True, "rerank_window": 20}),
    # the fast ingest is refused unless an int8 embed takes RGB instead
    ("TPU.FAST_DECODE", {"use_int8_gallery": True}),
])
def test_service_refuses_unported_options(option, kwargs):
    """Nothing here is refused any more. ``mesh`` is ported: the 4 rows
    are sharded two ways, 128 rows a shard (K1's tile), the pads at
    +inf. ``rerank_window`` is ported, on the bf16 / fp32 and the int8
    gallery: it builds, clamped to the gallery's 4 rows.
    ``TPU.FAST_DECODE`` is ported: without an int8 embed the service
    ingests packed YUV420, on either gallery."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    cfg = get_default_cfg()
    if option == "TPU.FAST_DECODE":
        cfg.TPU.FAST_DECODE = True
    args = (cfg, np.ones((4, 8), np.float32), list("abcd"))
    if option == "rerank_window":
        svc = RetrievalService(*args, device="cpu",
                               model=torch.nn.Identity(), **kwargs)
        assert svc.rerank_window == 4
        return
    if option == "TPU.FAST_DECODE":
        svc = RetrievalService(*args, device="cpu",
                               model=torch.nn.Identity(), **kwargs)
        assert svc.ingest_format == "yuv420"
        return
    mesh = make_retrieval_mesh(devices=kwargs["mesh"])
    svc = RetrievalService(*args, model=torch.nn.Identity(), mesh=mesh)
    assert svc.mesh is mesh and svc.device == torch.device("cpu")
    assert [tuple(g.shape) for g in svc._gf] == [(128, 8)] * 2
    assert torch.isinf(svc._gn[0][0, 4:]).all() and torch.isinf(
        svc._gn[1]).all()


def test_fast_decode_with_an_int8_embed_serves_rgb():
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    cfg = get_default_cfg()
    cfg.TPU.FAST_DECODE = True
    svc = RetrievalService(cfg, np.ones((4, 8), np.float32), list("abcd"),
                           device="cpu", model=torch.nn.Identity(),
                           int8_qfn=_Int8EmbedStub(), use_int8_gallery=True)
    assert svc.ingest_format == "rgb"


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": _CPU_MESH}, "mesh"),
    ({"exact_rescore": False, "rerank_window": 8}, "re-rank"),
])
def test_service_refuses_int8_gallery_combinations(kwargs, match):
    """The reference's guards: the int8 gallery is single-device, and its
    capacity mode keeps no full-precision rows to re-rank."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    if "mesh" in kwargs:
        kwargs = {"mesh": make_retrieval_mesh(devices=kwargs["mesh"])}
    with pytest.raises(ValueError, match=match):
        RetrievalService(get_default_cfg(), np.ones((4, 8), np.float32),
                         list("abcd"), device="cpu", model=object(),
                         use_int8_gallery=True, **kwargs)


def test_service_refuses_empty_gallery():
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    with pytest.raises(ValueError, match="empty gallery"):
        RetrievalService(get_default_cfg(), np.zeros((0, 8), np.float32), [],
                         device="cpu", model=object())
