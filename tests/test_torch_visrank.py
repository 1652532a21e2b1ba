"""Rank visualisation (metrics/visrank.py) against the JAX package's
``visualize_ranked_results`` (OpenCV) on the same distance matrix and the
same uniform-colour PNGs, on the CPU.

Each image is one colour, so a slot's interior names the image in it. What
must match exactly: the files written, the grid's shape, the slot order
(each slot's interior colour), each slot's border colour (its corner
pixel: black for the query, green for a match, red otherwise) and every
interior pixel. Where border and image mix, OpenCV's fixed-point linear
resize and the port's float one may round apart: every pixel is held
within one level."""

import os

import numpy as np
import pytest
from PIL import Image

from centroids_reid_tpu.data.datasets import Record as JRecord
from centroids_reid_tpu_torch.data.datasets import Record
from centroids_reid_tpu_torch.metrics import visrank as V

cv2 = pytest.importorskip("cv2")
from centroids_reid_tpu.metrics import visrank as JV  # noqa: E402

W, H = 16, 32


def _write(tmp_path, prefix, specs, rng):
    """specs: (pid, camid) each; one uniform-colour 40x22 PNG per entry
    (another size than the grid's, so the first resize runs too)."""
    out = []
    for i, (pid, camid) in enumerate(specs):
        p = tmp_path / f"{prefix}_{i:03d}.png"
        Image.fromarray(np.full((40, 22, 3), rng.randint(20, 236, 3),
                                np.uint8)).save(p)
        out.append((str(p), pid, camid, i))
    return out


def _both(tmp_path, distmat, query, gallery, **kw):
    """Run both packages; returns [(port grid, JAX grid)] per file."""
    outs = []
    for name, mod, rec in (("port", V, Record), ("jax", JV, JRecord)):
        d = str(tmp_path / name)
        mod.visualize_ranked_results(
            distmat, [rec(*q) for q in query], [rec(*g) for g in gallery],
            d, width=W, height=H, **kw)
        outs.append(d)
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1]))
    return names, [tuple(np.asarray(Image.open(os.path.join(d, n)).convert(
        "RGB")) for d in outs) for n in names]


def _slots(grid, topk):
    starts = [0] + [k * (W + V.GRID_SPACING) + V.QUERY_EXTRA_SPACING
                    for k in range(1, topk + 1)]
    return [grid[:, s:s + W] for s in starts]


def _assert_grids_match(port, ref, topk):
    assert port.shape == ref.shape == (
        H, (topk + 1) * W + topk * V.GRID_SPACING + V.QUERY_EXTRA_SPACING, 3)
    assert np.abs(port.astype(int) - ref.astype(int)).max() <= 1
    for k, (a, b) in enumerate(zip(_slots(port, topk), _slots(ref, topk))):
        np.testing.assert_array_equal(a[4:-4, 4:-4], b[4:-4, 4:-4])
        np.testing.assert_array_equal(a[0, 0], b[0, 0])
        assert tuple(a[0, 0]) in ((V.BLACK,) if k == 0 else (V.GREEN, V.RED,
                                                             (255,) * 3))


def test_visualize_plain_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    query = _write(tmp_path, "q", [(1, 0), (2, 1), (3, 0)], rng)
    gallery = _write(tmp_path, "g", [(1, 1), (1, 0), (2, 0), (3, 1), (2, 2),
                                     (4, 0), (3, 0)], rng)
    distmat = rng.rand(3, 7)
    names, grids = _both(tmp_path, distmat, query, gallery, topk=4)
    assert names == ["q_000.png", "q_001.png", "q_002.png"]
    for port, ref in grids:
        _assert_grids_match(port, ref, 4)
    # the first query (pid 1, camera 0): its nearest kept entry's slot is
    # green for pid 1 and red otherwise; g_001 (pid 1, camera 0) is skipped
    order = [j for j in np.argsort(distmat[0]) if j != 1]
    first = grids[0][0][:, V.QUERY_EXTRA_SPACING + W + V.GRID_SPACING:]
    want = V.GREEN if gallery[order[0]][1] == 1 else V.RED
    assert tuple(first[0, 0]) == want


@pytest.mark.parametrize("respect", [False, True])
def test_visualize_centroids_matches_jax(tmp_path, respect):
    """Centroid mode: one seeded representative per centroid (the same in
    both packages), camera sets with ``respect_camids``."""
    rng = np.random.RandomState(1)
    query = _write(tmp_path, "q", [(1, 0), (1, 2), (2, 0), (3, 1)], rng)
    gallery = _write(tmp_path, "g", [(1, 0), (1, 1), (1, 2), (2, 1), (2, 0),
                                     (3, 0), (3, 2), (4, 1)], rng)
    reps = V.centroid_representatives([Record(*q) for q in query],
                                      [Record(*g) for g in gallery], respect)
    assert reps == JV.centroid_representatives(
        [JRecord(*q) for q in query], [JRecord(*g) for g in gallery],
        respect)
    distmat = rng.rand(len(query), len(reps))
    names, grids = _both(tmp_path, distmat, query, gallery, topk=3,
                         use_centroids=True, respect_camids=respect)
    assert len(names) == len(query)
    for port, ref in grids:
        _assert_grids_match(port, ref, 3)


def test_visualize_max_number_and_gallery_check(tmp_path):
    """``max_number`` 1 writes queries 0 and 1, as the reference; a
    distance matrix of the wrong width is refused."""
    rng = np.random.RandomState(2)
    query = _write(tmp_path, "q", [(1, 0), (2, 1), (1, 1)], rng)
    gallery = _write(tmp_path, "g", [(1, 1), (2, 0), (3, 0)], rng)
    names, grids = _both(tmp_path, rng.rand(3, 3), query, gallery, topk=2,
                         max_number=1)
    assert names == ["q_000.png", "q_001.png"]
    for port, ref in grids:
        _assert_grids_match(port, ref, 2)
    with pytest.raises(ValueError, match="gallery dim"):
        V.visualize_ranked_results(
            np.zeros((3, 2)), [Record(*q) for q in query],
            [Record(*g) for g in gallery], str(tmp_path / "bad"))


@pytest.mark.parametrize("size", [(40, 22, 32, 16), (262, 134, 256, 128),
                                  (128, 64, 256, 128)])
def test_resize_linear_within_one_level_of_cv2(size):
    """On random images (every pixel mixes) the float resize stays within
    one level of OpenCV's fixed-point one; a uniform image stays uniform."""
    h, w, dh, dw = size
    img = np.random.RandomState(3).randint(0, 256, (h, w, 3)).astype(np.uint8)
    diff = (V._resize_linear(img, dw, dh).astype(int)
            - cv2.resize(img, (dw, dh)).astype(int))
    assert np.abs(diff).max() <= 1
    flat = np.full((h, w, 3), (9, 130, 251), np.uint8)
    np.testing.assert_array_equal(V._resize_linear(flat, dw, dh),
                                  cv2.resize(flat, (dw, dh)))
