"""Dataset index construction (host-side, cheap).

Produces plain index tables — lists of records (path, pid, camid, idx) — and
per-pid dictionaries; all image IO happens later in the loader. Behavioural
parity targets:

* Market1501 (reference datasets/market1501.py:70-94): glob *.jpg,
  filename regex ``([-\\d]+)_c(\\d)``, junk pid==-1 skipped, train pids
  relabelled to 0..N-1, camid 1..6 shifted to 0-base.
* DukeMTMC-reID (reference datasets/dukemtmcreid.py): same pattern,
  camids 1..8.
* COCO-ReID (reference datasets/bases.py:158-336): annotations carry
  ``pair_id`` (the identity); query/gallery JSON paths are derived from the
  train JSON path by name substitution (:172-173); camid is 0 for
  train/query and 1 for gallery (:226-229); train pair_ids with <= 1 image
  are filtered out (:252-274); train pids relabelled (:280-281).
* num_query = len(query), num_classes = number of train pids
  (market1501.py:67-68).
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple


class Record(NamedTuple):
    path: str
    pid: int
    camid: int
    idx: int


class ReidDataset:
    """Index tables for one re-id dataset."""

    def __init__(self, name: str):
        self.name = name
        self.train: List[Record] = []
        self.train_dict: Dict[int, List[Record]] = {}
        self.query: List[Record] = []
        self.gallery: List[Record] = []

    @property
    def val(self) -> List[Record]:
        """Eval set = query followed by gallery (datasets/bases.py:205-207)."""
        return self.query + self.gallery

    @property
    def num_query(self) -> int:
        return len(self.query)

    @property
    def num_classes(self) -> int:
        return len(self.train_dict)

    # -- statistics (mirrors the printed table, datasets/bases.py:61-87) ---
    def _stats(self, records):
        pids = {r.pid for r in records}
        cams = {r.camid for r in records}
        return len(pids), len(records), len(cams)

    def print_statistics(self):
        rows = [
            ("train", *self._stats(self.train)),
            ("query", *self._stats(self.query)),
            ("gallery", *self._stats(self.gallery)),
        ]
        print("Dataset statistics:")
        print("  ----------------------------------------")
        print("  subset   | # ids | # images | # cameras")
        print("  ----------------------------------------")
        for name, np_, ni, nc in rows:
            print(f"  {name:<8} | {np_:5d} | {ni:8d} | {nc:9d}")
        print("  ----------------------------------------")


_FILENAME_PATTERN = re.compile(r"([-\d]+)_c(\d)")


def _parse_image_dir(
    dir_path: str, relabel: bool, max_pid: int, max_camid: int
) -> Tuple[List[Record], Dict[int, List[Record]]]:
    img_paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pids_seen = set()
    parsed = []
    for p in img_paths:
        m = _FILENAME_PATTERN.search(p)
        if m is None:
            continue
        pid, camid = int(m.group(1)), int(m.group(2))
        if pid == -1:
            continue  # junk images
        if not (0 <= pid <= max_pid):
            raise ValueError(f"pid {pid} out of range in {p}")
        if not (1 <= camid <= max_camid):
            raise ValueError(f"camid {camid} out of range in {p}")
        pids_seen.add(pid)
        parsed.append((p, pid, camid - 1))

    pid2label = {pid: i for i, pid in enumerate(sorted(pids_seen))}
    records, by_pid = [], defaultdict(list)
    for idx, (p, pid, camid) in enumerate(parsed):
        label = pid2label[pid] if relabel else pid
        rec = Record(p, label, camid, idx)
        records.append(rec)
        by_pid[label].append(rec)
    return records, dict(by_pid)


def _check_dirs(*dirs):
    for d in dirs:
        if not osp.isdir(d):
            raise RuntimeError(f"'{d}' is not available")


def load_market1501(root: str) -> ReidDataset:
    base = osp.join(root, "market1501")
    train_dir = osp.join(base, "bounding_box_train")
    query_dir = osp.join(base, "query")
    gallery_dir = osp.join(base, "bounding_box_test")
    _check_dirs(base, train_dir, query_dir, gallery_dir)

    ds = ReidDataset("market1501")
    ds.train, ds.train_dict = _parse_image_dir(train_dir, True, 1501, 6)
    ds.query, _ = _parse_image_dir(query_dir, False, 1501, 6)
    ds.gallery, _ = _parse_image_dir(gallery_dir, False, 1501, 6)
    return ds


def load_dukemtmc(root: str) -> ReidDataset:
    # reference layout: ROOT_DIR/DukeMTMC-reID/* (dukemtmcreid.py:44-47)
    base = osp.join(root, "DukeMTMC-reID")
    if not osp.isdir(base):
        base = osp.join(root, "dukemtmc-reid", "DukeMTMC-reID")
    train_dir = osp.join(base, "bounding_box_train")
    query_dir = osp.join(base, "query")
    gallery_dir = osp.join(base, "bounding_box_test")
    _check_dirs(base, train_dir, query_dir, gallery_dir)

    ds = ReidDataset("dukemtmcreid")
    ds.train, ds.train_dict = _parse_image_dir(train_dir, True, 8000, 8)
    ds.query, _ = _parse_image_dir(query_dir, False, 8000, 8)
    ds.gallery, _ = _parse_image_dir(gallery_dir, False, 8000, 8)
    return ds


# ---------------------------------------------------------------------------
# COCO-ReID (DeepFashion / Street2Shop jsons produced by the prep scripts)
# ---------------------------------------------------------------------------


def _parse_coco_split(
    images_dir: str, json_path: str, camid: int, mode: str
) -> Tuple[List[Record], Dict[int, List[Record]]]:
    with open(json_path) as f:
        js = json.load(f)

    id_to_filename = {im["id"]: im["file_name"] for im in js["images"]}
    pair_to_images = defaultdict(list)
    for ann in js["annotations"]:
        pair_id = ann["pair_id"]
        if pair_id < 0:
            raise ValueError(f"negative pair_id in {json_path}")
        img_id = ann["image_id"]
        if img_id in id_to_filename:
            pair_to_images[pair_id].append(id_to_filename[img_id])

    pair_ids = sorted(pair_to_images)
    if mode == "train":
        before = len(pair_ids)
        pair_ids = [p for p in pair_ids if len(pair_to_images[p]) > 1]
        print(
            f"Filtered out {before - len(pair_ids)} pair ids with single image"
        )
        pid2label = {p: i for i, p in enumerate(pair_ids)}
    else:
        pid2label = None

    records, by_pid = [], defaultdict(list)
    idx = 0
    for pair_id in pair_ids:
        label = pid2label[pair_id] if pid2label else pair_id
        for fname in pair_to_images[pair_id]:
            rec = Record(osp.join(images_dir, fname), label, camid, idx)
            records.append(rec)
            by_pid[label].append(rec)
            idx += 1
    return records, dict(by_pid)


def load_coco_reid(name: str, root: str, json_train_path: str) -> ReidDataset:
    if not json_train_path:
        raise ValueError("DATASETS.JSON_TRAIN_PATH is not specified")
    json_query = json_train_path.replace("train", "query")
    json_gallery = json_train_path.replace("train", "gallery")
    train_dir = osp.join(root, "train")
    query_dir = osp.join(root, "query")
    gallery_dir = osp.join(root, "gallery")
    _check_dirs(root, train_dir, query_dir, gallery_dir)
    for p in (json_train_path, json_query, json_gallery):
        if not osp.exists(p):
            raise RuntimeError(f"'{p}' is not available")

    ds = ReidDataset(name)
    # camid := 0 for train/query, 1 for gallery (datasets/bases.py:226-229)
    ds.train, ds.train_dict = _parse_coco_split(
        train_dir, json_train_path, 0, "train"
    )
    ds.query, _ = _parse_coco_split(query_dir, json_query, 0, "query")
    ds.gallery, _ = _parse_coco_split(gallery_dir, json_gallery, 1, "gallery")
    return ds


def init_dataset(name: str, cfg) -> ReidDataset:
    """Factory mirroring datasets/__init__.py:16-31."""
    root = cfg.DATASETS.ROOT_DIR
    if name == "market1501":
        return load_market1501(root)
    if name == "dukemtmcreid":
        return load_dukemtmc(root)
    if name in ("df1", "street2shop"):
        return load_coco_reid(name, root, cfg.DATASETS.JSON_TRAIN_PATH)
    raise KeyError(f"Unknown dataset: {name}")
