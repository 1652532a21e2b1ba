"""The port stands without JAX and without the JAX package: importing it,
serving a query on the CPU through the bf16 path and the int8 path (PTQ
embed + int8 gallery), an ONLY_TEST evaluation through its runner, a
one-epoch training run and its resume, the offline CLIs' flows, and
importing ``chip_smoke`` load neither jax nor flax nor optax nor orbax nor
any module of ``centroids_reid_tpu``; no source file of the port imports
it; and the service refuses what is not ported."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import cpu_subprocess_env

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import io, os, sys, tempfile
    import numpy as np
    import torch
    from PIL import Image
    import centroids_reid_tpu_torch
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine import runner
    from centroids_reid_tpu_torch.inference import (
        RetrievalService, build_embeddings, find_similar)
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model
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
    qfn = quantize_reid_model(model, [img[None]], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD, use_pallas=True)
    svc = RetrievalService(cfg, gallery, [str(i) for i in range(40)], k=3,
                           device="cpu", model=model, int8_qfn=qfn,
                           use_int8_gallery=True)
    d, idx, _ = svc.query_bytes([buf.getvalue()])
    assert d.shape == (1, 3) and np.isfinite(d).all(), d

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
        out = runner.run_single(cfg, "ctl", "test", device="cpu")
        assert 0.0 <= out["test_plain_mAP"] <= 1.0, out
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
    for module in ("losses/triplet.py", "losses/centroid.py",
                   "losses/classification.py", "solver/build.py",
                   "data/sampler.py", "data/device_data.py",
                   "engine/steps.py", "engine/state.py",
                   "engine/epoch_runner.py", "engine/checkpoint.py",
                   "engine/fit.py", "utils/preemption.py",
                   "utils/profiling.py", "utils/seeding.py"):
        assert f"centroids_reid_tpu_torch/{module}" in scanned, module


class _Int8EmbedStub:
    """Stands in for a QuantizedEmbed where the service is only built."""

    def to(self, device):
        return self


@pytest.mark.parametrize("option,kwargs", [
    ("mesh", {"mesh": object()}),
    ("rerank_window", {"rerank_window": 20}),
    ("TPU.FAST_DECODE", {}),
    # re-ranking stays unported on the int8 gallery too
    ("rerank_window", {"use_int8_gallery": True, "rerank_window": 20}),
    # the fast ingest is refused unless an int8 embed takes RGB instead
    ("TPU.FAST_DECODE", {"use_int8_gallery": True}),
])
def test_service_refuses_unported_options(option, kwargs):
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    cfg = get_default_cfg()
    if option == "TPU.FAST_DECODE":
        cfg.TPU.FAST_DECODE = True
    with pytest.raises(NotImplementedError, match=f"{option} .*not ported"):
        RetrievalService(cfg, np.ones((4, 8), np.float32), list("abcd"),
                         device="cpu", model=object(), **kwargs)


def test_fast_decode_with_an_int8_embed_serves_rgb():
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

    import torch

    cfg = get_default_cfg()
    cfg.TPU.FAST_DECODE = True
    svc = RetrievalService(cfg, np.ones((4, 8), np.float32), list("abcd"),
                           device="cpu", model=torch.nn.Identity(),
                           int8_qfn=_Int8EmbedStub(), use_int8_gallery=True)
    assert svc.ingest_format == "rgb"


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": object()}, "mesh"),
    ({"exact_rescore": False, "rerank_window": 8}, "re-rank"),
])
def test_service_refuses_int8_gallery_combinations(kwargs, match):
    """The reference's guards: the int8 gallery is single-device, and its
    capacity mode keeps no full-precision rows to re-rank."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService

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
