"""Serving: image -> top-k retrieval against a device-resident gallery.

Counterpart of ``centroids_reid_tpu/inference/service.py`` on one device:
decode on the host, then normalise -> backbone -> BNNeck (or the int8 PTQ
embed, which takes the uint8 image itself) -> (optional) L2 -> top-k
selection on the bf16 / fp32 gallery or on the int8 gallery index -> exact
fp32 re-score and sort. Only the uint8 query batch and the k results cross
the host boundary.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.transforms import ingest_blobs, normalize_batch
from ..ops.retrieval import (
    _G_TILE,
    _Q_TILE,
    _SCORE_BUDGET_BYTES,
    _pad_rows,
    check_k,
    topk_select,
)
from ..ops.retrieval_int8 import (
    Int8Gallery,
    default_margin,
    quantize_gallery,
    topk_select_int8,
)
from .api import load_inference_model

_NOT_PORTED = "is not ported yet; see ROADMAP.md queue 1 ({})"


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


def embed_query(model, imgs_u8, mean, std, dtype, normalize: bool):
    """uint8 [B, H, W, 3] on the model's device -> fp32 [B, D] embeddings
    (L2-normalised when ``normalize``). The NHWC batch enters the model as
    a channels_last NCHW view."""
    x = normalize_batch(imgs_u8, mean, std, dtype)
    e = model.embed(x.permute(0, 3, 1, 2))
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

    ``mesh``, ``rerank_window`` and ``TPU.FAST_DECODE`` without an int8
    embed are not ported yet and raise ``NotImplementedError``, as does a
    selection depth above 4096 against more than 32768 gallery rows
    (``ops.retrieval.check_k``). An empty gallery, and the reference's
    refused combinations (``mesh`` or, in capacity mode, ``rerank_window``
    with the int8 gallery), raise ``ValueError``.
    """

    def __init__(self, cfg, gallery_embeddings: np.ndarray,
                 gallery_paths: Sequence, k: int = 10, normalize: bool = True,
                 use_bf16_kernel: bool = True, *, device, model=None,
                 max_query_batch: int = 512, exact_rescore: bool = True,
                 mesh=None, use_int8_gallery: bool = False,
                 rerank_window: int = 0, int8_calib_imgs=None, int8_qfn=None):
        int8_embed = int8_qfn is not None or int8_calib_imgs is not None
        if use_int8_gallery and mesh is not None:
            raise ValueError(
                "use_int8_gallery is the single-device capacity lever; a "
                "mesh shards fp32/bf16 rows: use one at a time")
        if use_int8_gallery and not exact_rescore and rerank_window:
            raise ValueError(
                "use_int8_gallery with exact_rescore=False (capacity mode) "
                "cannot re-rank: the windowed k-reciprocal core needs the "
                "full-precision rows")
        unported = {
            "mesh": (mesh is not None, "multi-GPU"),
            "rerank_window": (bool(rerank_window), "re-ranking"),
            # an int8 embed takes RGB, so it never reads the fast ingest
            "TPU.FAST_DECODE": (bool(cfg.TPU.FAST_DECODE) and not int8_embed,
                                "fast ingest"),
        }
        for name, (used, item) in unported.items():
            if used:
                raise NotImplementedError(f"{name} " + _NOT_PORTED.format(item))
        g = len(gallery_paths)
        if g == 0:
            raise ValueError("empty gallery")
        self.cfg = cfg
        self.device = torch.device(device)
        self.k = int(min(k, g))
        self.normalize = normalize
        self.paths = np.asarray(gallery_paths)
        self.model = (load_inference_model(cfg, self.device) if model is None
                      else model.to(self.device).eval())

        gf = np.asarray(gallery_embeddings, np.float32)
        if normalize:
            gf = gf / np.maximum(np.linalg.norm(gf, axis=1, keepdims=True),
                                 1e-12)
        gf, gn = _pad_gallery(gf, _G_TILE)
        gf_t = torch.from_numpy(gf).to(self.device)
        self.use_int8_gallery = bool(use_int8_gallery)
        if self.use_int8_gallery:
            # the margin is clamped to the REAL row count, so +inf pad rows
            # never become candidates
            self._int8_sel = min(g, default_margin(self.k))
            check_k(self._int8_sel, gf.shape[0])
            gal = quantize_gallery(gf_t)  # zero pad rows -> zero codes
            gn_i8 = gal.gn.clone()
            gn_i8[g:] = float("inf")      # pads never win selection
            self._gf = Int8Gallery(gal.codes, gal.scale, gn_i8)
            # capacity mode: the codes are the only resident gallery state
            self._gf32 = gf_t[:g].contiguous() if exact_rescore else None
        else:
            check_k(self.k, gf.shape[0])
            kernel_dtype = torch.bfloat16 if use_bf16_kernel else torch.float32
            self._gf = gf_t.to(kernel_dtype)
            self._gf32 = gf_t[:g].contiguous() if exact_rescore else self._gf
            self._gn = torch.from_numpy(gn).to(self.device)[None, :]

        self.max_query_batch = int(max_query_batch)
        if self.use_int8_gallery or not (use_bf16_kernel and self.k <= 32):
            # the [B, Gp] fp32 score matrix stays within the score budget
            cap = max(128, (_SCORE_BUDGET_BYTES // (gf.shape[0] * 4))
                      // 128 * 128)
            self.max_query_batch = min(self.max_query_batch, cap)
        self._mean = tuple(cfg.INPUT.PIXEL_MEAN)
        self._std = tuple(cfg.INPUT.PIXEL_STD)
        self._in_dtype = (torch.bfloat16 if cfg.USE_MIXED_PRECISION
                          else torch.float32)

        self._qfn = None
        if int8_qfn is not None:
            self._qfn = int8_qfn.to(self.device)
        elif int8_calib_imgs is not None:
            from ..models.quantized import quantize_reid_model

            self._qfn = quantize_reid_model(
                self.model, [np.asarray(int8_calib_imgs)], self._mean,
                self._std, calib_percentile=cfg.TPU.INT8_CALIB_PCT)

    @torch.inference_mode()
    def _run(self, imgs_u8: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(self.device)
        if self._qfn is None:
            e = embed_query(self.model, x, self._mean, self._std,
                            self._in_dtype, self.normalize)
        else:
            e = self._qfn(x)
            if self.normalize:
                e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
        if self.use_int8_gallery:
            d, idx = ranked_query_int8(e, self._gf, self._gf32, self.k,
                                       sel=self._int8_sel)
        else:
            d, idx = ranked_query(e, self._gf, self._gf32, self._gn, self.k)
        return d.cpu().numpy(), idx.cpu().numpy()

    def query_arrays(self, imgs_u8: np.ndarray):
        """uint8 [B, H, W, 3] -> (distances [B, k], indices [B, k], paths).

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
    def ingest_format(self) -> str:
        """The wire format ``ingest_bytes`` produces: always ``"rgb"``. An
        int8 embed consumes uint8 RGB even with ``TPU.FAST_DECODE`` set, and
        without one the packed-YUV420 ingest is refused at construction
        (not ported yet)."""
        return "rgb"

    def ingest_bytes(self, blobs: Sequence[bytes]) -> np.ndarray:
        """Encoded image bytes -> the uint8 RGB batch ``query_arrays``
        takes. Host work only."""
        return ingest_blobs(self.ingest_format,
                            tuple(self.cfg.INPUT.SIZE_TEST), blobs)

    def query_bytes(self, blobs: Sequence[bytes]):
        """Encoded image bytes -> (distances, indices, paths)."""
        return self.query_arrays(self.ingest_bytes(blobs))

    def query_files(self, image_paths: Sequence[str]):
        def _read(p):
            with open(p, "rb") as f:
                return f.read()

        return self.query_bytes([_read(p) for p in image_paths])
