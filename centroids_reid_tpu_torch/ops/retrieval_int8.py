"""int8-quantized gallery retrieval (a scalar-quantized index, FAISS-SQ8
style) on a hand-written CUDA score kernel (Hopper).

Counterpart of ``centroids_reid_tpu/ops/retrieval_int8.py``. Each gallery
row is stored as int8 codes with one fp32 scale, ``row ~ scale * codes``;
``gn`` is the squared norm of the DEQUANTIZED row, so selection ranks the
vectors it scores. Candidate selection scores the codes on K4
(``scores_i8``: bf16 queries, codes widened to bf16 exactly, fp32
accumulation, scale applied after the product), keeps the
``default_margin(k)`` best per query on the hierarchical top-k (K3), and
re-scores those exactly in fp32: against the fp32 rows (exact mode) or
against their own dequantized codes (capacity mode, ``gf32=None``, where
the codes are the only resident gallery state).

The wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches K4 or raises. Each launch adds one to
``LAUNCHES["scores_i8"]``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .retrieval import (
    _G_TILE,
    _INF,
    _Q_TILE,
    _SCORE_BUDGET_BYTES,
    _check,
    _finalize_distances,
    _hier_topk_build,
    _on_cpu,
    _pad_rows,
    _stream,
)

LAUNCHES: Dict[str, int] = {"scores_i8": 0}
# K4's output tile: 256 gallery rows x 128 query rows
_I8_TILE_G = 256


def reset_launch_counts() -> None:
    LAUNCHES["scores_i8"] = 0


class Int8Gallery(NamedTuple):
    """A scalar-quantized gallery index: ``codes`` int8 [G, D], per-row
    dequantization ``scale`` fp32 [G], and ``gn`` fp32 [G], the squared
    norms of the dequantized rows."""

    codes: torch.Tensor
    scale: torch.Tensor
    gn: torch.Tensor

    @property
    def num_rows(self) -> int:
        return int(self.codes.shape[0])


def quantize_gallery(gf: torch.Tensor) -> Int8Gallery:
    """Per-row symmetric int8 quantization of a [G, D] gallery:
    ``scale = max(amax, 1e-30) / 127``, codes rounded half to even and
    clipped to +-127. The division by 127 is a multiplication by its fp32
    reciprocal, as XLA compiles the reference's division by a constant, so
    both packages give the same scales bit for bit."""
    gf32 = gf.float()
    amax = gf32.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-30) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(gf32 / scale), -127, 127).to(torch.int8)
    deq_gn = scale[:, 0] ** 2 * (codes.float() ** 2).sum(dim=1)
    return Int8Gallery(codes=codes, scale=scale[:, 0], gn=deq_gn)


def default_margin(k: int) -> int:
    """Candidates re-scored per query: ``k + max(16, k // 4)``."""
    return k + max(16, k // 4)


# --------------------------------------------------------------- K4 ------

def _scores_i8_blocks(q: int, g: int, sms: int) -> int:
    """K4's persistent grid over its 256 x 128 output tiles (the last
    gallery tile half empty when G % 256 == 128): one block per SM at
    most, never more blocks than tiles, so each block strides over the
    floor or the ceiling of an even share."""
    return max(1, min((q // _Q_TILE) * -(-g // _I8_TILE_G), sms))


def scores_i8_plain(qf, codes, s_row, gn_row):
    """``gn_row - 2 s_row (q . codes^T)`` in fp32; the scale is applied
    after the product, as the TPU kernel does."""
    return gn_row - 2.0 * (s_row * (qf.float() @ codes.float().T))


def scores_i8(qf, codes, s_row, gn_row):
    """K4: [Qp, D] bf16 x [Gp, D] int8 (+ s_row, gn_row [1, Gp] fp32) ->
    fp32 [Qp, Gp]. Kernel shapes: Qp % 128 == 0, Gp % 128 == 0,
    D % 32 == 0; contiguous, 16-byte aligned inputs."""
    if _on_cpu(qf, codes, s_row, gn_row):
        return scores_i8_plain(qf, codes, s_row, gn_row)
    from . import _build

    if qf.dtype != torch.bfloat16 or codes.dtype != torch.int8:
        raise TypeError(
            f"bf16 q and int8 codes required, got {qf.dtype}, {codes.dtype}")
    if s_row.dtype != torch.float32 or gn_row.dtype != torch.float32:
        raise TypeError(
            f"fp32 s_row and gn_row required, got {s_row.dtype}, "
            f"{gn_row.dtype}")
    if qf.dim() != 2 or codes.dim() != 2 or qf.shape[1] != codes.shape[1]:
        raise ValueError(f"shapes {tuple(qf.shape)} x {tuple(codes.shape)}")
    q, d = qf.shape
    g = codes.shape[0]
    if tuple(s_row.shape) != (1, g) or tuple(gn_row.shape) != (1, g):
        raise ValueError(f"s_row {tuple(s_row.shape)} and gn_row "
                         f"{tuple(gn_row.shape)} must be (1, {g})")
    if q % _Q_TILE or g % 128 or d % 32:
        raise ValueError(
            f"kernel tiles need Q % {_Q_TILE} == 0, G % 128 == 0 and "
            f"D % 32 == 0; got Q={q}, G={g}, D={d}"
        )
    args = (qf, codes, s_row, gn_row)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("q, codes, s_row and gn_row must be contiguous")
    # TMA reads q and codes from 16-byte aligned bases; s_row and gn_row
    # keep the same contract
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError(
            "q, codes, s_row and gn_row must start on a 16-byte boundary")
    out = torch.empty((q, g), dtype=torch.float32, device=qf.device)
    lib = _build.load()
    sms = lib.crt_sm_count()
    if sms < 1:
        raise RuntimeError("scores_i8: cannot read the device's SM count")
    rc = lib.crt_scores_i8(
        qf.data_ptr(), codes.data_ptr(), s_row.data_ptr(), gn_row.data_ptr(),
        out.data_ptr(), q, g, d, _scores_i8_blocks(q, g, sms), _stream(),
    )
    _check(rc, "scores_i8")
    LAUNCHES["scores_i8"] += 1
    return out


# ---------------------------------------------------------- selection ----

def topk_select_int8(qf, gal: Int8Gallery, gf32: Optional[torch.Tensor],
                     k: int, *, sel: int = 0):
    """int8-scored candidate selection + exact fp32 re-score -> top-k
    ``(raw scores [Q, k], indices [Q, k])``, raw = ``||g||^2 - 2 q.g``.

    ``qf`` [Q, D] (scored in bf16, re-scored in fp32); ``gf32`` the fp32
    rows, or ``None`` for capacity mode (candidates re-score against their
    dequantized codes). ``sel`` is the candidate margin (0 ->
    ``default_margin(k)``); a caller that pads ``gal`` passes ``sel``
    clamped to the real row count, so +inf pad rows never become
    candidates. Kernel shapes: Q % 128 == 0, G % 128 == 0.

    The order among equal re-scored distances is the lower position in the
    candidate list, as the reference's ``lax.top_k`` gives."""
    g = gal.num_rows
    k_eff = min(int(k), g)
    n_sel = min(g, int(sel) if sel else default_margin(k_eff))
    scores = scores_i8(qf.to(torch.bfloat16).contiguous(), gal.codes,
                       gal.scale[None, :], gal.gn[None, :])
    _, cand = _hier_topk_build(scores, n_sel)                 # [Q, n_sel]
    if gf32 is None:
        rows = gal.codes[cand].float() * gal.scale[cand][:, :, None]
    else:
        rows = gf32[cand]                                     # [Q, n_sel, D]
    dots = torch.einsum("qd,qnd->qn", qf.float(), rows)
    exact = (rows * rows).sum(dim=2) - 2.0 * dots
    val, order = torch.sort(exact, dim=1, stable=True)
    return val[:, :k_eff], torch.gather(cand, 1, order[:, :k_eff])


def topk_retrieval_int8(qf, gal: Int8Gallery, gf32: Optional[torch.Tensor],
                        k: int, dist: str = "euclidean",
                        sel: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``ops.retrieval.topk_retrieval`` over a quantized gallery index:
    (distances [Q, k], indices [Q, k]) as numpy arrays, distances in the
    reference's eval flavours (squared euclidean without sqrt, or
    ``|1 - cos|``). For cosine, quantize and pass the normalised rows. Runs
    on the device of ``qf``."""
    if dist == "cosine":
        qf = qf.float()
        qf = qf / qf.norm(dim=1, keepdim=True).clamp_min(1e-12)
    elif dist != "euclidean":
        raise ValueError(f"Unknown distance {dist!r}")
    if gf32 is not None:
        gf32 = gf32.float()

    g = gal.num_rows
    k_eff = min(k, g)
    # clamp the margin to the REAL row count before padding: a wider margin
    # would make +inf pad rows candidates
    sel = min(g, int(sel) if sel else default_margin(k_eff))
    pad_g = (-g) % _G_TILE
    if pad_g:
        gal = Int8Gallery(
            codes=_pad_rows(gal.codes, pad_g),
            scale=torch.cat([gal.scale, gal.scale.new_ones(pad_g)]),
            gn=torch.cat([gal.gn, gal.gn.new_full((pad_g,), _INF)]),
        )

    q, gp = qf.shape[0], gal.num_rows
    chunk = max(_Q_TILE, min(4096, (_SCORE_BUDGET_BYTES // (gp * 4))
                             // _Q_TILE * _Q_TILE))
    vals, idxs = [], []
    for start in range(0, q, chunk):
        qc = qf[start:start + chunk]
        rows = qc.shape[0]
        target = chunk if q > chunk else -(-rows // _Q_TILE) * _Q_TILE
        v, i = topk_select_int8(_pad_rows(qc, target - rows), gal, gf32,
                                k_eff, sel=sel)
        vals.append(v[:rows])
        idxs.append(i[:rows])
    val, idx = _finalize_distances(torch.cat(vals), torch.cat(idxs), qf, dist)
    return val.cpu().numpy(), idx.cpu().numpy()
