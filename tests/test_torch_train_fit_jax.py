"""The port's ``fit`` returns and logs the metrics the JAX package's ``fit``
does, by name: one ctl epoch of each on the same tiny synthetic
Market-1501 layout on the CPU (resnet18, 32x16, fp32, streamed epochs,
validation after the epoch, then the double test). The values differ: the
two packages draw different random weights and augmentations.
(``tests/test_torch_train_step.py`` holds each step's metrics by value.)"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.data import init_dataset as jax_init_dataset
from centroids_reid_tpu.engine.fit import fit as jax_fit
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data import init_dataset
from centroids_reid_tpu_torch.engine.fit import fit


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_keys")
    base = root / "market1501"
    rng = np.random.RandomState(0)
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        (base / sub).mkdir(parents=True)
    for pid in range(4):
        for sub, n, cam in (("bounding_box_train", 3, 1), ("query", 1, 1),
                            ("bounding_box_test", 2, 2)):
            for i in range(n):
                Image.fromarray(rng.randint(0, 256, (32, 16, 3)).astype(
                    np.uint8)).save(base / sub / (
                        f"{pid + 1:04d}_c{cam + i}s1_{i:06d}_00.jpg"))
    return str(root)


def _logged_keys(log_dir):
    """Key sets of the epoch record and of the validation record."""
    recs = [json.loads(line) for line in open(
        os.path.join(log_dir, "train", "metrics.jsonl"))]
    recs = [set(r) - {"step", "time"} for r in recs if "step" in r]
    return recs[0], recs[1]


def test_fit_metric_names_equal_jax(data_root, tmp_path):
    keys = []
    for make, run, load, device in (
            (jax_default_cfg, jax_fit, jax_init_dataset, None),
            (get_default_cfg, fit, init_dataset, "cpu")):
        cfg = make()
        cfg.merge_from_list([
            "DATASETS.ROOT_DIR", data_root, "MODEL.NAME", "resnet18",
            "MODEL.PRETRAINED", "False", "USE_MIXED_PRECISION", "False",
            "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_EPOCHS", "1",
            "SOLVER.EVAL_PERIOD", "1", "TPU.NUM_GROUPS", "1",
            "TPU.DEVICE_RESIDENT_DATA", "False",
            "DATALOADER.USE_RESAMPLING", "False"])
        log_dir = str(tmp_path / ("torch" if device else "jax"))
        kw = {"device": device} if device else {}
        out = run(cfg, "ctl", log_dir, dataset=load("market1501", cfg), **kw)
        keys.append((set(out), *_logged_keys(log_dir)))
    assert keys[0] == keys[1]
    returned, epoch, val = keys[1]
    assert {"epoch_train_loss", "epoch_dist_ap", "epoch_dist_an", "lr",
            "epoch_time_s", "steps", "centroid_triplet"} <= epoch
    assert "mAP" in val and {"test_centroids_mAP", "test_plain_mAP"} <= returned
