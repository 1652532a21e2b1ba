"""Rank visualisation: one PNG strip per query, the query image then its
top-k kept gallery images with green (same pid) or red borders
(counterpart of ``centroids_reid_tpu/metrics/visrank.py``).

The same grid as the reference: GRID_SPACING 2, QUERY_EXTRA_SPACING 8,
border width 3, each image resized to (width, height), bordered, and
resized back; entries the Market-1501 protocol removes (same pid and
camera, or camera-set membership in centroid mode) are skipped; in centroid
mode each centroid shows one member image drawn with ``random.Random(0)``
(``centroid_representatives``); the strip is ``<query image stem>.png`` in
``save_dir``, for queries 0..``max_number``.

Pillow and numpy instead of OpenCV. Where they differ:

* Colours: images are RGB here and BGR in the reference (``cv2.imread`` /
  ``cv2.imwrite``), so GREEN and RED are written in RGB order; the PNG
  files show the same colours.
* Resize: ``_resize_linear`` follows ``cv2.resize(INTER_LINEAR)``'s
  sampling (pixel centres, clamped edges, no antialiasing, unlike PIL's
  ``BILINEAR``) in floating point and rounds half up; OpenCV computes in
  fixed point (11-bit weights). A region of one colour stays that colour
  in both, so tile interiors agree exactly on uniform images; where
  border and image, or neighbouring pixels, mix, a pixel may differ by one
  level.
* Tie order: the gallery order is a stable argsort of the distances; the
  reference's ``np.argsort`` is not stable, so equal distances may order
  differently there.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import List, Sequence

import numpy as np

from ..data.datasets import Record

GRID_SPACING = 2
QUERY_EXTRA_SPACING = 8
BW = 3
GREEN = (0, 255, 0)     # RGB
RED = (255, 0, 0)       # RGB (the reference's BGR (0, 0, 255))
BLACK = (0, 0, 0)


def centroid_representatives(query_records: Sequence[Record],
                             gallery_records: Sequence[Record],
                             respect_camids: bool,
                             seed: int = 0) -> List[tuple]:
    """One representative (path, pid, camid tuple) per centroid, in the
    order ``metrics.centroids`` builds the centroids."""
    rng = random.Random(seed)
    g_by_pid = defaultdict(list)
    for r in gallery_records:
        g_by_pid[r.pid].append(r)
    q_by_pid = defaultdict(list)
    for r in query_records:
        q_by_pid[r.pid].append(r)

    reps: List[tuple] = []
    for pid in sorted(g_by_pid):
        recs = g_by_pid[pid]
        cams_g = np.asarray([r.camid for r in recs])
        if respect_camids:
            combos = set()
            q_cams = sorted({r.camid for r in q_by_pid.get(pid, [])})
            for cur in q_cams:
                sel = np.nonzero(cams_g != cur)[0]
                if sel.size == 0:
                    continue
                used = tuple(sorted({int(c) for c in cams_g[sel]}))
                if used in combos:
                    continue
                combos.add(used)
                rep = recs[int(rng.choice(list(sel)))]
                reps.append((rep.path, pid, used))
        else:
            rep = rng.choice(recs)
            reps.append((rep.path, pid, (rep.camid,)))
    return reps


def _axis_taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: (left index, right index,
    right weight) for each destination pixel."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    left = np.floor(f).astype(np.int64)
    frac = f - left
    low, high = left < 0, left >= src - 1
    frac[low | high] = 0.0
    left = np.clip(left, 0, src - 1)
    return left, np.minimum(left + 1, src - 1), frac


def _resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [h, w, 3] -> [height, width, 3] with ``cv2.resize``'s linear
    sampling, computed in float64 and rounded half up."""
    y0, y1, fy = _axis_taps(img.shape[0], height)
    x0, x1, fx = _axis_taps(img.shape[1], width)
    x = img.astype(np.float64)
    rows = x[y0] * (1.0 - fy)[:, None, None] + x[y1] * fy[:, None, None]
    out = (rows[:, x0] * (1.0 - fx)[None, :, None]
           + rows[:, x1] * fx[None, :, None])
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _load_with_border(path: str, color, width: int,
                      height: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"), np.uint8)
    img = _resize_linear(img, width, height)
    img = np.pad(img, ((BW, BW), (BW, BW), (0, 0)))
    img[:BW], img[-BW:], img[:, :BW], img[:, -BW:] = color, color, color, color
    return _resize_linear(img, width, height)


def visualize_ranked_results(distmat: np.ndarray,
                             query_records: Sequence[Record],
                             gallery_records: Sequence[Record],
                             save_dir: str, width: int = 128,
                             height: int = 256, topk: int = 10,
                             use_centroids: bool = False,
                             respect_camids: bool = False,
                             max_number: int = 1_000_000) -> None:
    """Write ``<query stem>.png`` under ``save_dir`` for queries 0 to
    ``max_number`` of the [Q, G] ``distmat`` (G the centroids in centroid
    mode)."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    num_q = distmat.shape[0]
    if use_centroids:
        gallery = centroid_representatives(query_records, gallery_records,
                                           respect_camids)
    else:
        gallery = [(r.path, r.pid, (r.camid,)) for r in gallery_records]
    if distmat.shape[1] != len(gallery):
        raise ValueError(f"distmat gallery dim {distmat.shape[1]} != "
                         f"{len(gallery)} entries")
    indices = np.argsort(distmat, axis=1, kind="stable")

    for q_idx in range(num_q):
        q = query_records[q_idx]
        grid = np.full(
            (height,
             (topk + 1) * width + topk * GRID_SPACING + QUERY_EXTRA_SPACING,
             3), 255, np.uint8)
        grid[:, :width] = _load_with_border(q.path, BLACK, width, height)
        rank_idx = 1
        for g_idx in indices[q_idx]:
            g_path, g_pid, g_cams = gallery[g_idx]
            if respect_camids:
                invalid = g_pid == q.pid and q.camid in g_cams
            else:
                invalid = g_pid == q.pid and q.camid == g_cams[0]
            if invalid:
                continue
            color = GREEN if g_pid == q.pid else RED
            start = rank_idx * (width + GRID_SPACING) + QUERY_EXTRA_SPACING
            grid[:, start:start + width] = _load_with_border(
                g_path, color, width, height)
            rank_idx += 1
            if rank_idx > topk:
                break
        stem = os.path.splitext(os.path.basename(q.path))[0]
        Image.fromarray(grid).save(os.path.join(save_dir, stem + ".png"))
        if (q_idx + 1) % 100 == 0:
            print(f"- done {q_idx + 1}/{num_q}")
        if q_idx >= max_number:
            break
    print(f'Done. Images have been saved to "{save_dir}" ...')
