"""k-reciprocal re-ranking (Zhong et al., CVPR 2017, arXiv:1701.08398).

Counterpart of ``centroids_reid_tpu/ops/rerank.py``, with the same
semantics (its module docstring states them; ``tests/np_oracle.py::
oracle_rerank`` is the loop oracle of both):

1. ``d``: pairwise eval-mode distances over ``concat(qf, gf)`` (fp32,
   squared euclidean or ``|1 - cos|``), row-max normalised to ``dn``;
2. ranks: each row's ``k1 + 1`` nearest rows, self included, ties to the
   lower index; ``R(i)``: the neighbours ``j`` of ``i`` that hold ``i`` among
   their own ``k1 + 1`` nearest;
3. expansion: ``R*(i)`` adds the half-level set ``Rh(j)`` (``k1 // 2 + 1``)
   of each ``j`` in ``R(i)`` with ``3 |Rh(j) & R(i)| > 2 |Rh(j)|``;
4. ``V[i, j] = exp(-dn[i, j])`` over ``R*(i)``, L1-normalised;
5. local query expansion (``k2 > 1``): ``V[i] <- mean(V[rank(i, :k2)])``;
6. Jaccard distance ``1 - minsum / (|Vq|_1 + |Vg|_1 - minsum)``;
7. ``lambda * dn[:Q, Q:] + (1 - lambda) * jaccard``.

Two entry points, both on the device of their tensor inputs (array inputs
go to ``device``, the card unless the caller asks for the CPU):

* ``rerank_distmat``: the full ``[Q, G]`` re-ranked matrix (ONLY_TEST,
  ``get_similar`` dense). ``d``, ``dn`` and ``V`` are ``[N, N]`` fp32, so it
  refuses ``N > max_n``. Where the reference scans padded chunks for static
  shapes, this loops over row blocks without padding; the Jaccard min-sum
  runs on ``[qb, gb, N]`` blocks of at most ``_BLOCK_BYTES``.
* ``rerank_topk``: windowed re-ranking for any gallery size. The exact fp32
  top-``r`` (``ops.retrieval.topk_retrieval``) narrows each query to its
  candidate window, then each query is re-ranked against its own window,
  batched over chunks of ``_WIN_CHUNK`` windows (``_windowed``; the serving
  path runs the same core).

The ranks of step 2 are ``ops.retrieval._exact_topk`` of each row (K3 on
the card, a stable sort on the CPU): the k smallest, ties to the lower
index, as ``lax.top_k(-d)``. The expansion's scatter-max over repeated
indices is ``scatter_reduce(amax)``, which is deterministic.
``_windowed_feats`` runs the same windowed core on pre-gathered candidate
rows, the form the sharded serving path has (its rows come from the
cross-shard gather of ``parallel.retrieval``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..losses.distances import _mm, get_dist_func
from .retrieval import _exact_topk, topk_retrieval_tensors

# queries per chunk of the windowed core: at r = 500, D = 2048 the chunk's
# [C, r + 1, D] candidate rows take 131 MB
_WIN_CHUNK = 32
# cap on each transient of the dense path (row blocks, Jaccard blocks)
_BLOCK_BYTES = 256 << 20

DEFAULT_MAX_N = 26_000


def _as_f32(x, device) -> torch.Tensor:
    """fp32 tensor: a tensor stays on its device, an array goes to
    ``device``."""
    if torch.is_tensor(x):
        return x.float()
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _take_rows(table, idx):
    """``table [C, n, m]``, ``idx [C, ...]`` -> ``[C, ..., m]``: row
    ``idx[c, ...]`` of set ``c`` (the batched ``table[idx]``)."""
    sets = torch.arange(table.shape[0], device=table.device)
    return table[sets.view(-1, *([1] * (idx.dim() - 1))), idx]


def _ranks(d, kk: int, hk: int):
    """Step 2 on ``d [C, n, n]``: ranks ``[C, n, kk]`` (nearest first),
    reciprocal masks at the full (``kk``) and half (``hk``) level, and the
    half-level set sizes ``[C, n]``."""
    c, n, _ = d.shape
    _, rank = _exact_topk(d.reshape(c * n, n).contiguous(), kk)
    rank = rank.view(c, n, kk)
    rows = torch.arange(n, device=d.device).view(1, n, 1, 1)
    recip = (_take_rows(rank, rank) == rows).any(-1)
    rank_h = rank[..., :hk]
    reciph = (_take_rows(rank_h, rank_h) == rows).any(-1)
    return rank, recip, reciph, reciph.sum(-1)


def _v_rows(dn_rows, nb, rc, rank, reciph, hsize):
    """Steps 3-4 for a block of rows of each set: ``dn_rows [C, R, n]``,
    their ranks ``nb [C, R, kk]`` and reciprocal masks ``rc``; ``rank``,
    ``reciph``, ``hsize`` of the whole sets. Returns ``V`` rows ``[C, R,
    n]``."""
    c, r, n = dn_rows.shape
    kk, hk = nb.shape[-1], reciph.shape[-1]
    ri = torch.zeros_like(dn_rows).scatter_reduce_(2, nb, rc.float(),
                                                   "amax", include_self=True)
    ch_idx = _take_rows(rank[..., :hk], nb)             # [C, R, kk, hk]
    ch_msk = _take_rows(reciph, nb)                     # [C, R, kk, hk]
    flat = ch_idx.reshape(c, r, kk * hk)
    ri_at = torch.gather(ri, 2, flat).view(c, r, kk, hk)
    inter = (ri_at * ch_msk).sum(-1).to(torch.int32)
    hs = torch.gather(hsize, 1, nb.reshape(c, r * kk)).view(c, r, kk)
    sel = rc & (3 * inter > 2 * hs)
    grow = (sel[..., None] & ch_msk).float()
    rstar = ri.scatter_reduce_(2, flat, grow.reshape(c, r, kk * hk), "amax",
                               include_self=True)
    w = torch.exp(-dn_rows) * rstar
    return w / w.sum(-1, keepdim=True).clamp_min(1e-12)


def _normalised(d):
    return d / d.amax(dim=-1, keepdim=True).clamp_min(1e-12)


# ------------------------------------------------------------ dense ------

def _row_block(n: int, per_row: int) -> int:
    return max(1, min(n, _BLOCK_BYTES // max(per_row, 1)))


def _build_distmat(feats, dist: str):
    """[N, D] -> [N, N] fp32 eval-mode distances, in row blocks."""
    fn = get_dist_func(dist, eval_mode=True)
    n = feats.shape[0]
    d = feats.new_empty((n, n))
    step = _row_block(n, 4 * 4 * n)  # the block and three temporaries
    for s in range(0, n, step):
        d[s:s + step] = fn(feats[s:s + step], feats)
    return d


def _build_v(dn, rank, recip, reciph, hsize):
    """Steps 3-4 over the whole [N, N] set, in row blocks."""
    n = dn.shape[0]
    kk, hk = rank.shape[-1], reciph.shape[-1]
    v = torch.empty_like(dn)
    step = _row_block(n, 4 * (3 * n + 4 * kk * hk))
    for s in range(0, n, step):
        e = min(n, s + step)
        v[s:e] = _v_rows(dn[None, s:e], rank[:, s:e], recip[:, s:e], rank,
                         reciph, hsize)[0]
    return v


def _query_expand(v, rank_k2):
    """Step 5: ``V[i] <- mean(V[rank(i, :k2)])``, in row blocks."""
    n, k2 = v.shape[0], rank_k2.shape[-1]
    out = torch.empty_like(v)
    step = _row_block(n, 4 * k2 * n)
    for s in range(0, n, step):
        out[s:s + step] = v[rank_k2[s:s + step]].mean(dim=1)
    return out


def _jaccard(vq, vg):
    """Step 6: [Q, N] x [G, N] -> [Q, G] Jaccard distances over [qb, gb, N]
    blocks of at most ``_BLOCK_BYTES``."""
    q, g, n = vq.shape[0], vg.shape[0], vq.shape[1]
    sq, sg = vq.sum(-1), vg.sum(-1)
    out = vq.new_empty((q, g))
    cells = _row_block(q * g, 4 * n)
    qb = max(1, min(q, 16, cells))
    gb = max(1, min(g, cells // qb))
    for a in range(0, q, qb):
        va = vq[a:a + qb, None, :]
        for b in range(0, g, gb):
            minsum = torch.minimum(va, vg[None, b:b + gb]).sum(-1)
            denom = (sq[a:a + qb, None] + sg[None, b:b + gb]
                     - minsum).clamp_min(1e-12)
            out[a:a + qb, b:b + gb] = 1.0 - minsum / denom
    return out


def rerank_distmat(qf, gf, k1: int = 20, k2: int = 6,
                   lambda_value: float = 0.3, dist: str = "euclidean",
                   max_n: int = DEFAULT_MAX_N, device="cuda") -> torch.Tensor:
    """k-reciprocal re-ranked distances: [Q, D] x [G, D] -> [Q, G] fp32 on
    the inputs' device. ``lambda_value`` 1.0 gives the row-max normalised
    original distances (the original ranking exactly), 0.0 the Jaccard
    distance alone."""
    qf, gf = _as_f32(qf, device), _as_f32(gf, device)
    gf = gf.to(qf.device)
    q, g = qf.shape[0], gf.shape[0]
    n = q + g
    if q == 0 or g == 0:
        return qf.new_zeros((q, g))
    if n > max_n:
        raise ValueError(
            f"re-ranking holds two [N, N] fp32 matrices in HBM; "
            f"N={n} exceeds max_n={max_n} (~{2 * n * n * 4 / 2**30:.1f} GB"
            f" + transients). Re-rank a centroid gallery, raise max_n on "
            f"a bigger chip, or use the streaming evaluator without "
            f"re-ranking for galleries at this scale."
        )
    k1 = max(1, min(int(k1), n - 1))
    # the rank matrix has k1 + 1 columns: the expansion takes at most those
    k2 = max(1, min(int(k2), k1 + 1))
    lam = float(lambda_value)
    d = _build_distmat(torch.cat([qf, gf]), dist)
    dn = _normalised(d)
    rank, recip, reciph, hsize = _ranks(d[None], k1 + 1, k1 // 2 + 1)
    del d
    v = _build_v(dn, rank, recip, reciph, hsize)
    if k2 > 1:
        v = _query_expand(v, rank[0, :, :k2])
    jac = _jaccard(v[:q], v[q:])
    del v
    return lam * dn[:q, q:] + (1.0 - lam) * jac


# ---------------------------------------------------------- windowed -----

def _local_dist(f, dist: str):
    """[C, n, D] -> [C, n, n] eval-mode distances within each candidate set,
    fp32 (TF32 off)."""
    f = f.float()
    if dist == "euclidean":
        sq = (f * f).sum(-1)
        return sq[:, :, None] + sq[:, None, :] - 2.0 * _mm(f, f)
    if dist == "cosine":
        fn = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return (1.0 - _mm(fn, fn)).abs().clamp_min(1e-12)
    raise ValueError(dist)


def _core(d, kk: int, hk: int, k2: int, lam: float):
    """Steps 2-7 on a batch of candidate sets: ``d [C, n, n]`` with row 0
    the query and rows 1..n-1 its candidates -> the re-ranked distances of
    the query to its candidates, ``[C, n - 1]``."""
    dn = _normalised(d)
    rank, recip, reciph, hsize = _ranks(d, kk, hk)
    v = _v_rows(dn, rank, recip, rank, reciph, hsize)
    if k2 > 1:
        v = _take_rows(v, rank[..., :k2]).mean(dim=2)
    vq, vg = v[:, 0], v[:, 1:]
    minsum = torch.minimum(vq[:, None, :], vg).sum(-1)
    denom = (vq.sum(-1)[:, None] + vg.sum(-1) - minsum).clamp_min(1e-12)
    jac = 1.0 - minsum / denom
    return lam * dn[:, 0, 1:] + (1.0 - lam) * jac


def _windowed_rows(qf, rows, r: int, lam: float, kk: int, hk: int, k2: int,
                   chunk: int, dist: str):
    """Re-ranked distances [Q, r] of each query to its ``r`` candidate rows
    ``rows(s, e) -> [e - s, r, D]``, in the candidates' order: chunks of
    ``chunk`` queries, each a batch of [C, r + 1, r + 1] local problems."""
    q = qf.shape[0]
    out = qf.new_empty((q, r), dtype=torch.float32)
    for s in range(0, q, chunk):
        f = torch.cat([qf[s:s + chunk, None, :].float(),
                       rows(s, s + chunk).float()], dim=1)
        out[s:s + chunk] = _core(_local_dist(f, dist), kk, hk, k2, lam)
    return out


def _windowed(qf, gf, idx, lam: float, kk: int, hk: int, k2: int,
              chunk: int, dist: str):
    """Re-ranked distances [Q, R] of each query to its candidate window
    ``idx [Q, R]`` (rows of ``gf``), in the window's order. ``gf`` may be a
    kernel-dtype copy; distances are fp32."""
    return _windowed_rows(qf, lambda s, e: gf[idx[s:e]], idx.shape[1], lam,
                          kk, hk, k2, chunk, dist)


def _windowed_feats(qf, cand, lam: float, kk: int, hk: int, k2: int,
                    chunk: int, dist: str):
    """``_windowed`` over pre-gathered candidate rows ``cand [Q, R, D]``
    instead of ``(gf, idx)``: the same math and output."""
    return _windowed_rows(qf, lambda s, e: cand[s:e], cand.shape[1], lam,
                          kk, hk, k2, chunk, dist)


def rerank_topk(qf, gf, r: int = 100, k1: int = 20, k2: int = 6,
                lambda_value: float = 0.3, dist: str = "euclidean",
                q_chunk: int = _WIN_CHUNK, device="cuda",
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed k-reciprocal re-ranking: [Q, D] x [G, D] -> (re-ranked
    distances [Q, r], gallery indices [Q, r]), nearest first, on the
    inputs' device. Each query is re-ranked against its own exact fp32
    top-``r`` window, i.e. ``rerank_distmat(qf[i:i+1], gf[window_i])``;
    candidates outside the window never enter it. ``r`` is clamped to the
    gallery size, ``k1`` to ``r``, ``k2`` to ``k1 + 1``.

    ``mesh`` selects the windows on the gallery sharded over it
    (``parallel.retrieval.sharded_topk``); array inputs then go to its
    first device. The windows' rows are still read from the whole ``gf``
    on the queries' device, as in the JAX package, so this entry does not
    spread the gallery's residency."""
    if mesh is not None:
        device = mesh.devices[0]
    qf, gf = _as_f32(qf, device), _as_f32(gf, device)
    gf = gf.to(qf.device)
    q, g = qf.shape[0], gf.shape[0]
    if q == 0 or g == 0:
        z = qf.new_zeros((q, 0))
        return z, z.long()
    r = max(1, min(int(r), g))
    k1 = max(1, min(int(k1), r))
    k2 = max(1, min(int(k2), k1 + 1))
    if mesh is not None:
        from ..parallel.retrieval import sharded_topk_tensors

        _, idx0 = sharded_topk_tensors(qf, gf, r, mesh, dist=dist)
        idx0 = idx0.to(qf.device)
    else:
        _, idx0 = topk_retrieval_tensors(qf, gf, r, dist=dist)
    vals = _windowed(qf, gf, idx0, float(lambda_value), k1 + 1, k1 // 2 + 1,
                     k2, max(1, min(int(q_chunk), q)), dist)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals, torch.gather(idx0, 1, order)
