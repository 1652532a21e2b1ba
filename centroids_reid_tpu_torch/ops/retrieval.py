"""Distance + top-k retrieval on hand-written CUDA kernels (Hopper).

Counterpart of ``centroids_reid_tpu/ops/retrieval.py``. Scores are the raw
squared-euclidean ``||g||^2 - 2 q.g`` (the rank-invariant ``||q||^2`` term is
added back by ``_finalize_distances``). Three kernels carry selection, each
beside its plain PyTorch version:

* K1 ``scores`` / ``scores_plain``: the bf16 score matrix, fp32 accumulate;
* K2 ``stream_topk`` / ``stream_topk_plain``: streaming top-k for bf16 at
  k <= 32, selected at bf16 score resolution, ties to the lower column;
* K2u ``stream_topk(packed=False)`` / ``stream_topk_plain(packed=False)``:
  the same streaming selection on exact fp32 scores (the TPU kernel's
  unpacked merge);
* K3 ``kpass_topk`` / ``kpass_topk_plain``: the exact fp32 k smallest of
  each row, ties to the lower column (a radix select in shared memory);
  the base case and final pass of the hierarchical top-k. Rows wider than
  one K3 row (32768 columns) take a stable sort instead, as the reference
  sends them to ``lax.top_k``.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises. Each launch adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

_Q_TILE = 128
_G_TILE = 1024
# cap on the materialised fp32 score buffer; queries are chunked beyond it
_SCORE_BUDGET_BYTES = 512 << 20
_KPASS_MAX_W = 32768  # one fp32 row in shared memory (128 KB)
_INF = float("inf")

LAUNCHES: Dict[str, int] = {"scores": 0, "stream_topk": 0,
                            "stream_topk_unpacked": 0, "kpass_topk": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True: all on the CPU (plain path). False: all on one CUDA device
    (kernel path). Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no retrieval kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        # the kernels launch on the current device's current stream
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return False


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_score_inputs(qf, gf, gn_row) -> Tuple[int, int, int]:
    if qf.dtype != torch.bfloat16 or gf.dtype != torch.bfloat16:
        raise TypeError(f"bf16 q and g required, got {qf.dtype}, {gf.dtype}")
    if gn_row.dtype != torch.float32:
        raise TypeError(f"fp32 gn_row required, got {gn_row.dtype}")
    if qf.dim() != 2 or gf.dim() != 2 or qf.shape[1] != gf.shape[1]:
        raise ValueError(f"shapes {tuple(qf.shape)} x {tuple(gf.shape)}")
    q, d = qf.shape
    g = gf.shape[0]
    if tuple(gn_row.shape) != (1, g):
        raise ValueError(f"gn_row {tuple(gn_row.shape)} != (1, {g})")
    if q % _Q_TILE or g % 128 or d % 32:
        raise ValueError(
            f"kernel tiles need Q % {_Q_TILE} == 0, G % 128 == 0 and "
            f"D % 32 == 0; got Q={q}, G={g}, D={d}"
        )
    if not (qf.is_contiguous() and gf.is_contiguous()
            and gn_row.is_contiguous()):
        raise ValueError("q, g and gn_row must be contiguous")
    # the kernels read q and g with 16-byte loads and gn_row with float4s
    if any(t.data_ptr() % 16 for t in (qf, gf, gn_row)):
        raise ValueError("q, g and gn_row must start on a 16-byte boundary")
    return q, g, d


# --------------------------------------------------------------- K1 ------

def scores_plain(qf, gf, gn_row):
    """``gn_row - 2 q.g^T`` in fp32 from bf16 (or fp32) inputs."""
    return gn_row - 2.0 * (qf.float() @ gf.float().T)


def scores(qf, gf, gn_row):
    """K1: [Qp, D] x [Gp, D] bf16 (+ gn_row [1, Gp] fp32) -> fp32 [Qp, Gp]."""
    if _on_cpu(qf, gf, gn_row):
        return scores_plain(qf, gf, gn_row)
    from . import _build

    q, g, d = _check_score_inputs(qf, gf, gn_row)
    out = torch.empty((q, g), dtype=torch.float32, device=qf.device)
    rc = _build.load().crt_scores(
        qf.data_ptr(), gf.data_ptr(), gn_row.data_ptr(), out.data_ptr(),
        q, g, d, _stream(),
    )
    _check(rc, "scores")
    LAUNCHES["scores"] += 1
    return out


# ---------------------------------------------------------- K2 / K2u ------

def stream_topk_plain(qf, gf, gn_row, k: int, packed: bool = True):
    """The k smallest scores per row, ordered by (score, column): with
    ``packed`` the bf16-rounded score of the TPU kernel's packed key, and
    the values are those bf16-rounded scores; without it the exact fp32
    score. Slots at +inf take column 0, as the TPU kernel's initial (+inf,
    0) entries win every tie there."""
    s = scores_plain(qf, gf, gn_row)
    if packed:
        s = s.to(torch.bfloat16).float()
    v, i = torch.sort(s, dim=1, stable=True)
    v, i = v[:, :k], i[:, :k]
    return v, torch.where(torch.isposinf(v), torch.zeros_like(i), i)


def _stream_splits(q: int, g: int, sms: int) -> int:
    """K2's persistent grid: gallery splits per 128-row query tile. The
    splits of all query tiles fill at most one wave of ``sms`` blocks (one
    block per SM), and every split holds at least one 128-row gallery
    tile. The kernel leaves one partial list per query row and split."""
    return max(1, min(g // 128, sms // (q // _Q_TILE)))


def stream_topk(qf, gf, gn_row, k: int, packed: bool = True):
    """Streaming top-k (k <= 32) -> (fp32 [Qp, k], int64 [Qp, k]).

    ``packed=True`` is K2: selection at bf16 score resolution. ``packed=
    False`` is K2u: exact fp32 scores (the TPU kernel's unpacked merge).
    Diverges from the TPU's unpacked kernel only where a row holds fewer
    than k scores below +inf: its +inf slots here take column 0, where the
    TPU kernel repeats the column of the row's minimum over its earlier
    gallery tiles (a taken entry stays in its merge buffer at +inf)."""
    if not 1 <= k <= 32:
        raise ValueError(f"stream_topk needs 1 <= k <= 32, got {k}")
    if _on_cpu(qf, gf, gn_row):
        return stream_topk_plain(qf, gf, gn_row, k, packed)
    from . import _build

    q, g, d = _check_score_inputs(qf, gf, gn_row)
    if k > g:
        raise ValueError(f"k={k} > gallery rows {g}")
    lib = _build.load()
    sms = lib.crt_sm_count()
    if sms < 1:
        raise RuntimeError("stream_topk: cannot read the device's SM count")
    n_splits = _stream_splits(q, g, sms)
    part = torch.empty((q, n_splits, k), dtype=torch.int64, device=qf.device)
    val = torch.empty((q, k), dtype=torch.float32, device=qf.device)
    idx = torch.empty((q, k), dtype=torch.int64, device=qf.device)
    launch, name = ((lib.crt_stream_topk, "stream_topk") if packed
                    else (lib.crt_stream_topk_unpacked, "stream_topk_unpacked"))
    rc = launch(
        qf.data_ptr(), gf.data_ptr(), gn_row.data_ptr(), part.data_ptr(),
        val.data_ptr(), idx.data_ptr(), q, g, d, k, n_splits, _stream(),
    )
    _check(rc, name)
    LAUNCHES[name] += 1
    return val, idx


# --------------------------------------------------------------- K3 ------

def kpass_topk_plain(x, k: int):
    """Exact k smallest per row, ties to the lowest column (lax.top_k's
    order); NaNs after every number, in column order (torch.sort's)."""
    v, i = torch.sort(x, dim=1, stable=True)
    return v[:, :k], i[:, :k]


@functools.lru_cache(maxsize=256)
def _kpass_plan(w: int, k: int) -> Tuple[int, int, int]:
    """K3's launch: (threads per row's block, n_sort, shared-memory bytes).
    1024 threads from W = 4096 up, else 256; where k exceeds the threads,
    a bitonic sort runs on n_sort, the power of two >= k. The shared memory
    holds the row's keys (W u32), then the larger of the warps' 256-bucket
    histograms and the n_sort u16 columns of the sort (the histograms'
    room also holds the k 8-byte entries ranked where k <= threads), then
    324 words of counts (the layout that ``retrieval.cu::kpass_smem_bytes``
    sizes)."""
    threads = 1024 if w >= 4096 else 256
    n_sort = 1 << (k - 1).bit_length()

    def round4(n):
        return -(-n // 4) * 4

    work = round4(max(threads // 32 * 256, (n_sort + 1) // 2))
    return threads, n_sort, 4 * (round4(w) + work + 256 + 64 + 4)


def kpass_topk(x, k: int):
    """K3: fp32 [Q, W] (W <= 32768) -> exact (values [Q, k], int64 [Q, k]),
    as ``kpass_topk_plain``: a radix select of the k-th smallest value on
    the row in shared memory, then an ordering of the k selected columns.

    Diverges from the TPU kernel only where a row holds fewer than k
    non-taken values below +inf: the TPU kernel then repeats its first
    +inf column, this one returns k distinct columns as lax.top_k does.
    NaN: the TPU kernel's ``jnp.min`` propagates a NaN into every later
    pass; this one follows its plain version (torch.sort), which puts NaNs
    after +inf, each with its own column."""
    if _on_cpu(x):
        return kpass_topk_plain(x, k)
    from . import _build

    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"kpass_topk needs contiguous fp32 [Q, W], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    q, w = x.shape
    if not 1 <= k <= w <= _KPASS_MAX_W:
        raise ValueError(
            f"kpass_topk needs 1 <= k <= W <= {_KPASS_MAX_W}; got k={k}, W={w}"
        )
    val = torch.empty((q, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((q, k), dtype=torch.int64, device=x.device)
    if q:
        threads, n_sort, smem = _kpass_plan(w, k)
        rc = _build.load().crt_kpass_topk(
            x.data_ptr(), val.data_ptr(), idx.data_ptr(), q, w, k, threads,
            n_sort, smem, _stream()
        )
        _check(rc, "kpass_topk")
        LAUNCHES["kpass_topk"] += 1
    return val, idx


# ---------------------------------------------------------- selection ----

def _exact_topk(x, k: int):
    """Exact k smallest per row, ties to the lower column: K3 for rows of
    up to 32768 columns, else a stable sort (the reference's ``lax.top_k``
    on rows too wide for its kernel; not a K3 launch)."""
    if x.shape[1] <= _KPASS_MAX_W:
        return kpass_topk(x, k)
    v, i = torch.sort(x, dim=1, stable=True)
    return v[:, :k], i[:, :k]


def _hier_topk_build(scores_, k: int):
    """Exact top-k-smallest via hierarchical group-min pruning (proof in
    ``centroids_reid_tpu.ops.retrieval.topk_retrieval``): the k smallest
    elements of a row lie in the k groups of 8 columns with the k smallest
    group minima. Recurse on the group minima, gather the <= 8k member
    columns, finish with one exact selection. Groups are strided (group j =
    columns {j, j + w8, ..., j + 7 w8}), as in the reference. The gathered
    columns keep their positions, so the last selection breaks ties by
    position, as ``lax.top_k`` does there."""
    q, w = scores_.shape
    if w <= max(16384, 8 * k):
        return _exact_topk(scores_, k)
    pad = (-w) % 8
    if pad:
        scores_ = torch.cat(
            [scores_, scores_.new_full((q, pad), _INF)], dim=1
        )
    w8 = scores_.shape[1] // 8
    gm = scores_.view(q, 8, w8).amin(dim=1)
    _, gsel = _hier_topk_build(gm.contiguous(), k)
    cols = (gsel[:, :, None]
            + w8 * torch.arange(8, device=scores_.device)).reshape(q, k * 8)
    v, sel = _exact_topk(torch.gather(scores_, 1, cols), k)
    return v, torch.gather(cols, 1, sel)


def topk_select(qf, gf, gn_row, k: int):
    """[Qp, D] x [Gp, D] (+ gn_row [1, Gp]) -> top-k ``(scores [Qp, k],
    indices [Qp, k])`` by the raw score ``||g||^2 - 2 q.g``.

    * bf16, k <= 32 -> K2 (``packed=True``; values at bf16 resolution);
    * bf16, k > 32  -> K1 + hierarchical exact top-k on K3;
    * fp32          -> a plain fp32 matmul (as the reference leaves its
      fp32 path to XLA) + the same hierarchical top-k.

    Only the indices are exact on every branch; consumers re-score the
    winners. Kernel shapes: Qp % 128 == 0, Gp % 128 == 0, pad columns of
    gn_row at +inf."""
    if qf.dtype == torch.bfloat16:
        if k <= 32:
            return stream_topk(qf, gf, gn_row, k, packed=True)
        s = scores(qf, gf, gn_row)
    else:
        s = scores_plain(qf, gf, gn_row)
    return _hier_topk_build(s, k)


def _pad_rows(x, rows: int):
    return torch.cat([x, x.new_zeros((rows, x.shape[1]))]) if rows else x


def topk_retrieval(qf, gf, k: int,
                   dist: str = "euclidean") -> Tuple[np.ndarray, np.ndarray]:
    """Top-k nearest gallery entries per query: (distances [Q, k], indices
    [Q, k]) as numpy arrays. Distances are the reference's eval flavours:
    squared euclidean without sqrt, or ``|1 - cos|``. bf16 inputs select on
    the kernels. Runs on the device of ``qf``."""
    val, idx = topk_retrieval_tensors(qf, gf, k, dist)
    return val.cpu().numpy(), idx.cpu().numpy()


def topk_retrieval_tensors(qf, gf, k: int, dist: str = "euclidean"):
    """``topk_retrieval`` with its results left on the device of ``qf``:
    (distances fp32 [Q, k], indices int64 [Q, k])."""
    if dist == "cosine":
        in_dtype = qf.dtype
        qf32, gf32 = qf.float(), gf.float()
        qf = (qf32 / qf32.norm(dim=1, keepdim=True).clamp_min(1e-12)).to(in_dtype)
        gf = (gf32 / gf32.norm(dim=1, keepdim=True).clamp_min(1e-12)).to(in_dtype)
        gnorm2 = torch.ones(gf.shape[0], device=gf.device)
    elif dist == "euclidean":
        gnorm2 = (gf.float() * gf.float()).sum(dim=1)
    else:
        raise ValueError(f"Unknown distance {dist!r}")

    g = gf.shape[0]
    k_eff = min(k, g)
    pad_g = (-g) % _G_TILE
    gf = _pad_rows(gf, pad_g)
    gnorm2 = torch.cat([gnorm2, gnorm2.new_full((pad_g,), _INF)])
    gn_row = gnorm2[None, :]
    q, gp = qf.shape[0], gf.shape[0]

    if qf.dtype == torch.bfloat16 and k_eff <= 32:
        # K2 selects at bf16 resolution; re-score the winners exactly
        qf_p = _pad_rows(qf, (-q) % _Q_TILE)
        _, idx = topk_select(qf_p, gf, gn_row, k_eff)
        idx = idx[:q]
        g_sel = gf[idx].float()
        val = gnorm2[idx] - 2.0 * torch.einsum("qd,qkd->qk", qf.float(), g_sel)
        val, order = torch.sort(val, dim=1, stable=True)
        return _finalize_distances(val, torch.gather(idx, 1, order), qf, dist)

    # chunk queries so the fp32 score buffer stays bounded
    chunk = max(_Q_TILE, min(4096, (_SCORE_BUDGET_BYTES // (gp * 4))
                             // _Q_TILE * _Q_TILE))
    vals, idxs = [], []
    for start in range(0, q, chunk):
        qc = qf[start:start + chunk]
        rows = qc.shape[0]
        target = chunk if q > chunk else -(-rows // _Q_TILE) * _Q_TILE
        v, i = topk_select(_pad_rows(qc, target - rows), gf, gn_row, k_eff)
        vals.append(v[:rows])
        idxs.append(i[:rows])
    return _finalize_distances(torch.cat(vals), torch.cat(idxs), qf, dist)


def _finalize_distances(val, idx, qf, dist):
    """Scores -> reference distance flavour (add back the rank-invariant
    ||q||^2 term / map to |1 - cos|)."""
    if dist == "cosine":
        sim = (1.0 - val) / 2.0
        val = (1.0 - sim).abs().clamp_min(1e-12)
    else:
        val = val + (qf.float() * qf.float()).sum(dim=1)[:, None]
    return val, idx
