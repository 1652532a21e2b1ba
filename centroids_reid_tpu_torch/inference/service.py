"""Serving: image -> top-k retrieval against a device-resident gallery.

Counterpart of ``centroids_reid_tpu/inference/service.py``: decode on the
host (to RGB, or with ``TPU.FAST_DECODE`` to packed YUV420, half the bytes
to the card), then unpack and normalise -> backbone -> BNNeck (or the int8
PTQ embed, which takes the uint8 RGB image itself) -> (optional) L2 -> top-k
selection on the bf16 / fp32 gallery or on the int8 gallery index -> exact
fp32 re-score and sort -> (optional) windowed k-reciprocal re-ranking of
each query's top-r window. Only the uint8 query batch and the k results
cross the host boundary. With a ``mesh`` the gallery is sharded over its
devices (``parallel/``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.transforms import (
    ingest_blobs,
    normalize_batch,
    normalize_yuv420_batch,
)
from ..models.transreid import family, is_transformer, refuse
from ..ops.rerank import _WIN_CHUNK, _windowed, _windowed_feats
from ..ops.retrieval import (
    _G_TILE,
    _Q_TILE,
    _SCORE_BUDGET_BYTES,
    _pad_rows,
    topk_select,
)
from ..ops.retrieval_int8 import (
    Int8Gallery,
    default_margin,
    quantize_gallery,
    topk_select_int8,
)
from ..parallel.mesh import GALLERY_AXIS, on_device, shard_width, split_rows
from ..parallel.retrieval import (
    SHARD_ALIGN,
    make_sharded_row_gather,
    shard_select_merge,
)
from .api import load_inference_model

# why the /search service and the HTTP front refuse a transformer
SEARCH_WHY = ("a /search request carries images and no camera id, which "
              "TransReID's SIE needs, and no transformer's serving path is "
              "ported")


def ranked_query(e, gf, gf32, gn, k: int):
    """[B, D] embeddings -> exact-fp32-sorted ``(distances [B, k], indices
    [B, k])`` against a resident gallery padded to the kernel tile: queries
    padded to 128 rows, kernel-dtype selection (``ops.retrieval.
    topk_select``), then exact fp32 re-score of the winners against
    ``gf32`` and a stable sort."""
    b = e.shape[0]
    _, idx = topk_select(_pad_rows(e.to(gf.dtype), (-b) % _Q_TILE), gf, gn, k)
    idx = idx[:b]
    g_sel = gf32[idx].float()
    e32 = e.float()
    d = ((e32 * e32).sum(dim=1)[:, None] + (g_sel * g_sel).sum(dim=2)
         - 2.0 * torch.einsum("qd,qkd->qk", e32, g_sel))
    d, order = torch.sort(d, dim=1, stable=True)
    return d, torch.gather(idx, 1, order)


def reranked_query(e, gf, gf32, gn, k: int, r: int, k1: int, k2: int,
                   lam: float, dist: str = "euclidean"):
    """``ranked_query`` at depth ``r``, then windowed k-reciprocal
    re-ranking of each query's top-``r`` window (``ops.rerank._windowed``,
    the core of ``rerank_topk``). Returns ``(scores [B, k], indices [B,
    k])`` ascending by ``lam * dn + (1 - lam) * jaccard``, the values that
    ``get_similar`` with ``TPU.RERANK_WINDOW`` saves. ``dist`` is the
    re-rank's local distance; selection is always the euclidean raw score,
    rank-equivalent to cosine on L2-normalised rows."""
    _, idx0 = ranked_query(e, gf, gf32, gn, r)
    return _rerank_tail(e, gf32, idx0, k, r, k1, k2, lam, dist)


def _rerank_tail(e, gf32, idx0, k: int, r: int, k1: int, k2: int,
                 lam: float, dist: str):
    """Re-rank the selected windows ``idx0 [B, r]`` (the shared back half of
    ``reranked_query`` and ``reranked_query_int8``)."""
    return _rerank_windows(
        e, idx0, lambda *a: _windowed(e.float(), gf32, idx0, *a), k, r, k1,
        k2, lam, dist)


def _rerank_windows(e, idx0, windowed, k: int, r: int, k1: int, k2: int,
                    lam: float, dist: str):
    """The re-rank of ``_rerank_tail`` with the windowed core as
    ``windowed(lam, kk, hk, k2, chunk, dist)``; keeps the first ``k``."""
    # the clamps of ops.rerank.rerank_topk: r + 1 rows a set, k1 + 1 ranks
    k1c = max(1, min(int(k1), r))
    k2c = max(1, min(int(k2), k1c + 1))
    vals = windowed(float(lam), k1c + 1, k1c // 2 + 1, k2c,
                    max(1, min(_WIN_CHUNK, e.shape[0])), dist)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals[:, :k], torch.gather(idx0, 1, order[:, :k])


def ranked_query_int8(e, gal: Int8Gallery, gf32, k: int, sel: int = 0):
    """``ranked_query`` over an int8 gallery index: int8 candidate selection
    at margin ``sel`` (0 -> ``default_margin(k)``; the caller clamps it to
    the real row count when ``gal`` is padded), then the exact fp32
    re-score of ``topk_select_int8`` against ``gf32`` (or, with
    ``gf32=None``, capacity mode, against the dequantized codes). Distances
    are ``raw + ||e||^2`` with ``raw = gn_sel - 2 e.g``, ascending."""
    b = e.shape[0]
    val, idx = topk_select_int8(_pad_rows(e, (-b) % _Q_TILE), gal, gf32, k,
                                sel=sel)
    e32 = e.float()
    return val[:b] + (e32 * e32).sum(dim=1)[:, None], idx[:b]


def reranked_query_int8(e, gal: Int8Gallery, gf32, k: int, r: int, k1: int,
                        k2: int, lam: float, dist: str = "euclidean",
                        sel: int = 0):
    """``reranked_query`` with the window selected on the int8 index
    (margin semantics of ``ranked_query_int8``); the re-rank itself runs on
    the exact fp32 rows ``gf32``."""
    _, idx0 = ranked_query_int8(e, gal, gf32, r, sel=sel)
    return _rerank_tail(e, gf32, idx0, k, r, k1, k2, lam, dist)


def embed_query(model, imgs_u8, mean, std, dtype, normalize: bool,
                size_hw=None, cams=None):
    """uint8 RGB [B, H, W, 3], or packed YUV420 [B, 1.5 * H * W] of
    ``size_hw`` (``TPU.FAST_DECODE``), on the model's device -> fp32 [B, D]
    embeddings (L2-normalised when ``normalize``). The NHWC batch enters
    the model as a channels_last NCHW view; ``cams``, int64 [B] camera ids
    on the same device, go to ``model.embed`` when given (TransReID's SIE
    reads them, a ResNet does not)."""
    if imgs_u8.dim() == 2:
        x = normalize_yuv420_batch(imgs_u8, size_hw, mean, std, dtype)
    else:
        x = normalize_batch(imgs_u8, mean, std, dtype)
    x = x.permute(0, 3, 1, 2)
    e = model.embed(x) if cams is None else model.embed(x, cams)
    if normalize:
        e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return e


def _pad_gallery(gf: np.ndarray, unit: int):
    """Pad gallery rows to a multiple of ``unit``; returns (gf, gn) where
    padded rows are zero vectors with +inf squared norm so they can never
    win selection."""
    g = gf.shape[0]
    gn = (gf * gf).sum(axis=1)
    pad = (-g) % unit
    if pad:
        gf = np.concatenate([gf, np.zeros((pad, gf.shape[1]), gf.dtype)])
        gn = np.concatenate([gn, np.full((pad,), np.inf, np.float32)])
    return gf, gn


class RetrievalService:
    """Holds the model and a gallery resident on ``device``; answers
    queries.

    ``use_bf16_kernel`` selects on a bf16 gallery copy (the K1/K2/K3
    kernels; winners re-scored exactly in fp32), otherwise on the fp32
    gallery. ``exact_rescore=False`` drops the fp32 copy and re-scores from
    the kernel-dtype rows. At k > 32, or with the fp32 gallery, selection
    materialises a [B, G] fp32 score matrix, so ``max_query_batch`` is
    clamped against ``ops.retrieval._SCORE_BUDGET_BYTES``.

    ``use_int8_gallery=True`` replaces the kernel-dtype copy with a per-row
    int8 index (``ops.retrieval_int8``; K4 + K3): ``default_margin(k)``
    candidates per query re-scored exactly against the resident fp32 rows,
    or, with ``exact_rescore=False`` (capacity mode), against their own
    dequantized codes, the only resident gallery state. Its selection
    always materialises the [B, G] scores, so ``max_query_batch`` is always
    clamped.

    ``int8_qfn`` (a ``models.quantized.QuantizedEmbed``) or
    ``int8_calib_imgs`` (uint8 [N, H, W, 3] of the query domain, calibrated
    with the reference defaults) runs the embed as the int8 PTQ pipeline,
    which takes the uint8 RGB batch directly; ``int8_qfn`` takes precedence.

    ``rerank_window=r`` (r > 0) re-ranks each query's top-r window with
    k-reciprocal encoding after the exact re-score (``reranked_query``;
    ``rerank_k1``, ``rerank_k2``, ``rerank_lambda`` as ``TPU.RERANK_*``):
    the returned distances are the re-rank scores, equal to what
    ``get_similar`` with ``TPU.RERANK_WINDOW`` saves on the same inputs. r
    is clamped to [k, gallery]; the local distance is
    ``SOLVER.DISTANCE_FUNC``, and cosine needs ``normalize`` (euclidean
    selection is rank-equivalent to cosine only on unit rows). Selection
    runs at depth ``rerank_window or k``, which picks the route (K2 at
    bf16 depth <= 32, else a [B, G] score matrix), the int8 margin and the
    ``max_query_batch`` clamp.

    ``TPU.FAST_DECODE`` (``ingest_format`` "yuv420"): ``ingest_bytes``
    packs planar YUV420 and the embed unpacks it on the card; an int8 embed
    takes RGB, so with one the service ingests RGB.

    ``mesh`` (a ``parallel.Mesh`` of two or more devices; one device is
    the unsharded service, as in the JAX package) shards the gallery rows
    over its devices, padded to a multiple of 128 rows a shard (pad rows
    at ``gn = +inf``). The model, the embed and the merge run on the
    mesh's first device, which replaces ``device``. Each shard selects at
    kernel dtype (K1 + the hierarchical top-k on K3 for bf16, whatever
    k), re-scores its winners in exact fp32 against its own rows, and one
    exact top-k merges the shards' candidates
    (``parallel.retrieval.shard_select_merge``). With ``rerank_window``
    the window's rows come from the cross-shard gather and are re-ranked
    by ``ops.rerank._windowed_feats``. The sharded selection always
    materialises [B, shard rows] scores (and [B, r, D] rows when
    re-ranking), so ``max_query_batch`` is clamped on both. bf16 results
    can differ from the unsharded service's where bf16 scores tie: the
    sharded path picks each shard's candidates at bf16 resolution and
    merges them by exact distance, so it chooses from a superset; the
    fp32 route gives the same indices.

    The service runs on the card unless ``device`` says otherwise;
    ``query_arrays`` makes ``device`` current while it runs, so a service
    on ``cuda:1`` launches there from any thread. An empty gallery, and
    the reference's refused combinations (``mesh`` or, in capacity mode,
    ``rerank_window`` with the int8 gallery; cosine re-ranking without
    ``normalize``), raise ``ValueError``.
    """

    def __init__(self, cfg, gallery_embeddings: np.ndarray,
                 gallery_paths: Sequence, k: int = 10, normalize: bool = True,
                 use_bf16_kernel: bool = True, *, device="cuda", model=None,
                 max_query_batch: int = 512, exact_rescore: bool = True,
                 mesh=None, use_int8_gallery: bool = False,
                 rerank_window: int = 0, rerank_k1: int = 20,
                 rerank_k2: int = 6, rerank_lambda: float = 0.3,
                 int8_calib_imgs=None, int8_qfn=None):
        if is_transformer(cfg):
            refuse("the /search service", SEARCH_WHY, family(cfg))
        if mesh is not None and mesh.shape[GALLERY_AXIS] < 2:
            mesh = None
        if use_int8_gallery and mesh is not None:
            raise ValueError(
                "use_int8_gallery is the single-device capacity lever; a "
                "mesh shards fp32/bf16 rows: use one at a time")
        if use_int8_gallery and not exact_rescore and rerank_window:
            raise ValueError(
                "use_int8_gallery with exact_rescore=False (capacity mode) "
                "cannot re-rank: the windowed k-reciprocal core needs the "
                "full-precision rows")
        g = len(gallery_paths)
        if g == 0:
            raise ValueError("empty gallery")
        self.cfg = cfg
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else torch.device(device))
        self.k = int(min(k, g))
        self.rerank_window = (min(max(int(rerank_window), self.k), g)
                              if rerank_window else 0)
        self._rerank_params = (int(rerank_k1), int(rerank_k2),
                               float(rerank_lambda))
        self._rerank_dist = str(cfg.SOLVER.DISTANCE_FUNC)
        if (self.rerank_window and self._rerank_dist == "cosine"
                and not normalize):
            raise ValueError(
                "rerank_window with SOLVER.DISTANCE_FUNC='cosine' needs "
                "normalize=True (--normalize_features): on unnormalized "
                "features euclidean candidate selection is not "
                "rank-equivalent to cosine selection, so served results "
                "could not equal get_similar's re-ranked ones")
        # selection depth per query: it picks the route and the int8 margin
        k_sel = self.rerank_window or self.k
        self.normalize = normalize
        self.paths = np.asarray(gallery_paths)
        self.model = (load_inference_model(cfg, self.device) if model is None
                      else model.to(self.device).eval())

        gf = np.asarray(gallery_embeddings, np.float32)
        if normalize:
            gf = gf / np.maximum(np.linalg.norm(gf, axis=1, keepdims=True),
                                 1e-12)
        self.use_int8_gallery = bool(use_int8_gallery)
        kernel_dtype = torch.bfloat16 if use_bf16_kernel else torch.float32
        if mesh is not None:
            # shard s: rows s * width .. (s + 1) * width on mesh.devices[s]
            width = shard_width(g, len(mesh.devices), SHARD_ALIGN)
            gf, gn = _pad_gallery(gf, width * len(mesh.devices))
            f32 = split_rows(torch.from_numpy(gf), mesh, width)
            self._shard_rows = width
            self._gf = [x.to(kernel_dtype) for x in f32]
            self._gf32 = f32 if exact_rescore else self._gf
            self._gn = [x[None, :] for x in
                        split_rows(torch.from_numpy(gn), mesh, width)]
            self._gather_rows = make_sharded_row_gather(mesh, width)
            del f32
        elif self.use_int8_gallery:
            # the margin is clamped to the REAL row count, so +inf pad rows
            # never become candidates
            self._int8_sel = min(g, default_margin(k_sel))
            gf, gn = _pad_gallery(gf, _G_TILE)
            gf_t = torch.from_numpy(gf).to(self.device)
            gal = quantize_gallery(gf_t)  # zero pad rows -> zero codes
            gn_i8 = gal.gn.clone()
            gn_i8[g:] = float("inf")      # pads never win selection
            self._gf = Int8Gallery(gal.codes, gal.scale, gn_i8)
            # capacity mode: the codes are the only resident gallery state
            self._gf32 = gf_t[:g].contiguous() if exact_rescore else None
        else:
            gf, gn = _pad_gallery(gf, _G_TILE)
            gf_t = torch.from_numpy(gf).to(self.device)
            self._gf = gf_t.to(kernel_dtype)
            self._gf32 = gf_t[:g].contiguous() if exact_rescore else self._gf
            self._gn = torch.from_numpy(gn).to(self.device)[None, :]

        self.max_query_batch = int(max_query_batch)
        if (mesh is not None or self.use_int8_gallery
                or not (use_bf16_kernel and k_sel <= 32)):
            # the [B, width] fp32 scores (of a shard, on a mesh) stay within
            # the score budget
            width = self._shard_rows if mesh is not None else gf.shape[0]
            cap = max(128, (_SCORE_BUDGET_BYTES // (width * 4)) // 128 * 128)
            self.max_query_batch = min(self.max_query_batch, cap)
        if mesh is not None and self.rerank_window:
            # so do the window's gathered [B, r, D] fp32 rows
            cap = max(8, _SCORE_BUDGET_BYTES
                      // (self.rerank_window * gf.shape[1] * 4))
            self.max_query_batch = min(self.max_query_batch, cap)
        self._mean = tuple(cfg.INPUT.PIXEL_MEAN)
        self._std = tuple(cfg.INPUT.PIXEL_STD)
        self._in_dtype = (torch.bfloat16 if cfg.USE_MIXED_PRECISION
                          else torch.float32)
        self._size_hw = tuple(int(v) for v in cfg.INPUT.SIZE_TEST)

        self._qfn = None
        if int8_qfn is not None:
            self._qfn = int8_qfn.to(self.device)
        elif int8_calib_imgs is not None:
            from ..models.quantized import quantize_reid_model

            self._qfn = quantize_reid_model(
                self.model, [np.asarray(int8_calib_imgs)], self._mean,
                self._std, calib_percentile=cfg.TPU.INT8_CALIB_PCT)

    def _run(self, imgs_u8: np.ndarray):
        # threads start with cuda:0 current, and the kernels launch on the
        # current device's stream
        with on_device(self.device):
            return self._query(imgs_u8)

    @torch.inference_mode()
    def _query(self, imgs_u8: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(self.device)
        if self._qfn is None:
            e = embed_query(self.model, x, self._mean, self._std,
                            self._in_dtype, self.normalize, self._size_hw)
        else:
            e = self._qfn(x)
            if self.normalize:
                e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
        rr = self.rerank_window
        if self.mesh is not None:
            d, idx = self._sharded_query(e)
        elif self.use_int8_gallery and rr:
            d, idx = reranked_query_int8(
                e, self._gf, self._gf32, self.k, rr, *self._rerank_params,
                dist=self._rerank_dist, sel=self._int8_sel)
        elif self.use_int8_gallery:
            d, idx = ranked_query_int8(e, self._gf, self._gf32, self.k,
                                       sel=self._int8_sel)
        elif rr:
            d, idx = reranked_query(e, self._gf, self._gf32, self._gn,
                                    self.k, rr, *self._rerank_params,
                                    dist=self._rerank_dist)
        else:
            d, idx = ranked_query(e, self._gf, self._gf32, self._gn, self.k)
        return d.cpu().numpy(), idx.cpu().numpy()

    def _sharded_query(self, e):
        """Ranking on the sharded gallery (the JAX package's sharded run):
        per-shard selection at kernel dtype, an exact fp32 re-score of each
        shard's winners against its own fp32 rows, the merge, then with
        ``rerank_window`` the window's rows gathered across shards and
        re-ranked. Returns exact distances (or re-rank scores) ascending,
        and global indices."""
        e32 = e.float()

        def rescore(s, val, idx):
            g_sel = self._gf32[s][idx].float()
            es = e32.to(g_sel.device)
            d = ((es * es).sum(dim=1)[:, None] + (g_sel * g_sel).sum(dim=2)
                 - 2.0 * torch.einsum("qd,qkd->qk", es, g_sel))
            # pad rows (zero vectors at +inf score) must stay at +inf
            return torch.where(torch.isinf(val), val, d)

        rr = self.rerank_window
        d0, idx0 = shard_select_merge(
            self.mesh, e.to(self._gf[0].dtype), self._gf, self._gn,
            rr or self.k, self._shard_rows, rescore=rescore)
        if not rr:
            return d0, idx0
        cand = self._gather_rows(idx0, self._gf32)
        return _rerank_windows(
            e, idx0, lambda *a: _windowed_feats(e32, cand, *a), self.k, rr,
            *self._rerank_params, self._rerank_dist)

    def query_arrays(self, imgs_u8: np.ndarray):
        """uint8 [B, H, W, 3], or packed YUV420 [B, 1.5 * H * W] on the fast
        ingest, -> (distances [B, k], indices [B, k], paths).

        Batches beyond ``max_query_batch`` run in chunks, the tail chunk
        zero-padded to the chunk size, so peak memory stays O(chunk * G)."""
        b = imgs_u8.shape[0]
        cap = self.max_query_batch
        if b <= cap:
            d, idx = self._run(imgs_u8)
            return d, idx, self.paths[idx]
        ds, idxs = [], []
        for s in range(0, b, cap):
            chunk = np.asarray(imgs_u8[s:s + cap])
            rows = chunk.shape[0]
            if rows < cap:
                chunk = np.concatenate(
                    [chunk, np.zeros((cap - rows, *chunk.shape[1:]),
                                     chunk.dtype)])
            d, idx = self._run(chunk)
            ds.append(d[:rows])
            idxs.append(idx[:rows])
        d, idx = np.concatenate(ds), np.concatenate(idxs)
        return d, idx, self.paths[idx]

    @property
    def model_name(self) -> str:
        """``cfg.MODEL.NAME``, which the HTTP server's /healthz reports."""
        return str(self.cfg.MODEL.NAME)

    @property
    def input_size_hw(self):
        """``INPUT.SIZE_TEST``, the (H, W) of the images it embeds."""
        return self._size_hw

    @property
    def ingest_format(self) -> str:
        """The wire format ``ingest_bytes`` produces, shared with the HTTP
        front's /healthz and warm-up: ``"rgb"`` for an int8 embed (it
        consumes uint8 RGB), else ``inference.utils.serving_ingest_format``
        (``"yuv420"`` with ``TPU.FAST_DECODE``)."""
        from .utils import serving_ingest_format

        if self._qfn is not None:
            return "rgb"
        return serving_ingest_format(self.cfg)

    def ingest_bytes(self, blobs: Sequence[bytes]) -> np.ndarray:
        """Encoded image bytes -> the uint8 batch ``query_arrays`` takes:
        RGB [B, H, W, 3] or packed YUV420 [B, 1.5 * H * W]. Host work
        only."""
        return ingest_blobs(self.ingest_format, self._size_hw, blobs)

    def query_bytes(self, blobs: Sequence[bytes]):
        """Encoded image bytes -> (distances, indices, paths)."""
        return self.query_arrays(self.ingest_bytes(blobs))

    def query_files(self, image_paths: Sequence[str]):
        def _read(p):
            with open(p, "rb") as f:
                return f.read()

        return self.query_bytes([_read(p) for p in image_paths])
