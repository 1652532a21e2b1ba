"""The fashion datasets' COCO layout (DeepFashion consumer-to-shop and
Street2Shop, ``DATASETS.NAMES df1`` / ``street2shop`` with
``DATASETS.JSON_TRAIN_PATH``) through the port against the JAX package,
on the CPU, over one synthetic split written as the preparation tools lay
it out: ``train/``, ``query/`` and ``gallery/`` image folders and
``train_*.json`` / ``query_*.json`` / ``gallery_*.json`` annotations
(the query and gallery files named by replacing ``train`` in the train
file's path).

* ``load_coco_reid`` and ``init_dataset``: the records (path, pid, camid,
  index, in order) and ``train_dict`` equal the JAX parser's exactly:
  train pair ids relabelled 0..n-1 after single-image pairs are dropped,
  query camid 0 and gallery camid 1, raw pair ids as their pids;
* ONLY_TEST through both runners on one reference-format ``.pth``
  (resnet18, 32x32, fp32), ``MODEL.KEEP_CAMID_CENTROIDS`` True and False:
  the same metric keys, Top-k equal and mAP within 1e-6, as
  ``test_torch_eval.py`` holds Market-1501;
* the fashion recipe's training run (``configs/320_resnet50_ibn_a.yml``
  with the df1 script's overrides; the image size cut to 32x32, the
  ImageNet backbone file replaced by random weights, fp32 on the CPU):
  one CTL epoch of ResNet50-IBN-a through ``runner.main`` with
  validation, a checkpoint and the double test.
"""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu_torch.config import get_default_cfg
from test_torch_eval import small_cfg, write_reference_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FASHION_CFG = os.path.join(REPO, "configs", "320_resnet50_ibn_a.yml")


def write_coco(root, train, query, gallery, hw=(32, 32), seed=0):
    """A COCO-layout split under ``root`` (``train``, ``query``, ``gallery``
    map pair id -> image count); each pair a colour with per-image shifts
    and noise. Besides the annotated images, each JSON lists one image no
    annotation names. Returns the train JSON's path."""
    rng = np.random.RandomState(seed)
    pair_ids = sorted(set(train) | set(query) | set(gallery))
    colors = {p: rng.randint(40, 215, 3) for p in pair_ids}
    next_id = [100]
    for split, pairs in (("train", train), ("query", query),
                         ("gallery", gallery)):
        os.makedirs(os.path.join(root, split))
        images, anns = [], []
        # pair ids in a shuffled order, as an annotation file lists them
        for pair_id in rng.permutation(sorted(pairs)):
            for i in range(pairs[pair_id]):
                fname = f"{split}_{pair_id}_{i}.jpg"
                arr = np.clip(colors[pair_id] + rng.randint(-40, 41, 3)
                              + rng.randint(-20, 20, (*hw, 3)), 0, 255)
                Image.fromarray(arr.astype(np.uint8)).save(
                    os.path.join(root, split, fname))
                images.append({"id": next_id[0], "file_name": fname,
                               "width": hw[1], "height": hw[0]})
                anns.append({"id": next_id[0], "image_id": next_id[0],
                             "pair_id": int(pair_id), "source": "shop",
                             "bbox": [0, 0, hw[1], hw[0]]})
                next_id[0] += 1
        images.append({"id": next_id[0], "file_name": f"{split}_none.jpg"})
        next_id[0] += 1
        with open(os.path.join(root, f"{split}_{hw[0]}_{hw[1]}.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return os.path.join(root, f"train_{hw[0]}_{hw[1]}.json")


# pair 5 has one train image (dropped from train), pair 900 no train image
TRAIN = {3: 4, 5: 1, 8: 3, 11: 5, 14: 2, 20: 4, 27: 3, 31: 6}
QUERY = {3: 2, 8: 1, 11: 2, 20: 1, 27: 2, 900: 1}
GALLERY = {3: 3, 5: 2, 8: 2, 11: 3, 20: 2, 27: 3, 31: 2, 900: 2}


# the recipe's P = 12: twelve train pairs of 2 to 5 images
RECIPE_TRAIN = {p: 2 + p % 4 for p in range(40, 52)}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coco")
    root = str(tmp / "images_32_32")
    json_train = write_coco(root, TRAIN, QUERY, GALLERY)
    return root, json_train, tmp


@pytest.mark.parametrize("name", ["df1", "street2shop"])
def test_records_match_jax(coco, name):
    from centroids_reid_tpu.data import datasets as JD
    from centroids_reid_tpu_torch.data import datasets as TD

    root, json_train, _ = coco
    ref = JD.load_coco_reid(name, root, json_train)
    got = TD.load_coco_reid(name, root, json_train)
    for split in ("train", "query", "gallery"):
        assert ([tuple(r) for r in getattr(got, split)]
                == [tuple(r) for r in getattr(ref, split)]), split
    assert ({k: [tuple(r) for r in v] for k, v in got.train_dict.items()}
            == {k: [tuple(r) for r in v] for k, v in ref.train_dict.items()})
    assert got.name == ref.name == name
    assert got.num_classes == ref.num_classes == len(TRAIN) - 1
    assert got.num_query == ref.num_query == sum(QUERY.values())
    assert {r.camid for r in got.query} == {0}
    assert {r.camid for r in got.gallery} == {1}
    assert sorted({r.pid for r in got.gallery}) == sorted(GALLERY)
    assert sorted(got.train_dict) == list(range(len(TRAIN) - 1))

    for make, init in ((jax_default_cfg, JD.init_dataset),
                       (get_default_cfg, TD.init_dataset)):
        cfg = make()
        cfg.DATASETS.ROOT_DIR = root
        cfg.DATASETS.JSON_TRAIN_PATH = json_train
        ds = init(name, cfg)
        assert [tuple(r) for r in ds.val] == [tuple(r) for r in got.val]


def test_refusals_match_jax(coco, tmp_path):
    from centroids_reid_tpu.data import datasets as JD
    from centroids_reid_tpu_torch.data import datasets as TD

    root, json_train, _ = coco
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="JSON_TRAIN_PATH"):
            mod.load_coco_reid("df1", root, "")
        with pytest.raises(RuntimeError, match="is not available"):
            mod.load_coco_reid("df1", root, str(tmp_path / "train_x.json"))
    bad = tmp_path / "bad"
    for split in ("train", "query", "gallery"):
        (bad / split).mkdir(parents=True)
        (bad / f"{split}.json").write_text(json.dumps({
            "images": [{"id": 1, "file_name": "a.jpg"}],
            "annotations": [{"image_id": 1, "pair_id": -1}]}))
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="negative pair_id"):
            mod.load_coco_reid("df1", str(bad), str(bad / "train.json"))


@pytest.mark.parametrize("keep_camids", [True, False])
def test_only_test_on_coco_matches_jax(coco, keep_camids):
    """ONLY_TEST through both runners: centroids first, then plain."""
    from centroids_reid_tpu.engine import runner as jrunner
    from centroids_reid_tpu_torch.engine import runner

    root, json_train, tmp = coco
    pth = str(tmp / "reid.pth")
    if not os.path.exists(pth):
        write_reference_pth(pth)
    out = []
    for make, run, kw in ((jax_default_cfg, jrunner.run_single, {}),
                          (get_default_cfg, runner.run_single,
                           {"device": "cpu"})):
        cfg = small_cfg(make, pth, root, str(tmp / f"logs_{len(out)}"))
        cfg.DATASETS.NAMES = "df1"
        cfg.DATASETS.JSON_TRAIN_PATH = json_train
        cfg.INPUT.SIZE_TEST = [32, 32]
        cfg.MODEL.KEEP_CAMID_CENTROIDS = keep_camids
        out.append(run(cfg, "ctl", "test", **kw))
    ref, got = out
    assert sorted(got) == sorted(ref)
    for key in ref:
        if "mAP" in key:
            assert abs(got[key] - ref[key]) <= 1e-6, key
        else:
            assert got[key] == ref[key], key
    assert 0.0 < got["test_plain_mAP"] < 1.0


def test_fashion_recipe_trains_one_epoch(coco):
    """``runner.main --mode ctl --config_file configs/320_resnet50_ibn_a.yml``
    with the df1 script's overrides (P = 12, K = 4, BASE_LR 1e-4, no
    resampling, KEEP_CAMID_CENTROIDS False, USE_CENTROIDS True), cut to
    32x32 and one epoch on the CPU."""
    from centroids_reid_tpu_torch.engine import runner

    tmp = coco[2]
    root = str(tmp / "recipe_32_32")
    json_train = write_coco(root, RECIPE_TRAIN, {40: 1, 41: 1, 42: 1},
                            {40: 2, 41: 2, 42: 2, 43: 2}, seed=1)
    out_dir = str(tmp / "recipe")
    res = runner.main([
        "--mode", "ctl", "--config_file", FASHION_CFG, "--device", "cpu",
        "DATASETS.NAMES", "df1", "DATASETS.JSON_TRAIN_PATH", json_train,
        "DATASETS.ROOT_DIR", root, "SOLVER.IMS_PER_BATCH", "12",
        "TEST.IMS_PER_BATCH", "16", "SOLVER.BASE_LR", "1e-4",
        "OUTPUT_DIR", out_dir, "DATALOADER.USE_RESAMPLING", "False",
        "MODEL.KEEP_CAMID_CENTROIDS", "False", "MODEL.USE_CENTROIDS", "True",
        "MODEL.PRETRAINED", "False", "INPUT.SIZE_TRAIN", "[32,32]",
        "INPUT.SIZE_TEST", "[32,32]", "USE_MIXED_PRECISION", "False",
        "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1",
        "REPRODUCIBLE_NUM_RUNS", "1", "DATALOADER.NUM_WORKERS", "2"])
    names = [f"test_{tag}_{m}" for tag in ("centroids", "plain")
             for m in ("mAP", "Top-1", "Top-10")]
    assert all(np.isfinite(res[n]) for n in names + ["mAP"]), res
    run = os.path.join(out_dir, "train_ctl_model", "version_0")
    with open(os.path.join(run, "config.yml")) as f:
        text = f.read()
    assert "resnet50_ibn_a" in text and "IMS_PER_BATCH: 12" in text
    with open(os.path.join(run, "train", "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch_train_loss" in r]
    assert [r["step"] for r in epochs] == [0] and epochs[0]["steps"] == 1
    assert np.isfinite(epochs[0]["epoch_train_loss"])
    assert os.listdir(os.path.join(run, "checkpoints")) == ["epoch=0"]
    assert sorted(os.listdir(os.path.join(
        run, "auto_checkpoints", "checkpoint_epoch0"))) == [
        "config.yml", "state.pt"]
    shutil.rmtree(out_dir)   # two ResNet50-IBN-a train states, 0.6 GB
