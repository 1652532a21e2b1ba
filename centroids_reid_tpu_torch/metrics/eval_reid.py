"""Market-1501-protocol CMC / mAP / top-k as mask algebra on the device
(counterpart of ``centroids_reid_tpu/metrics/eval_reid.py``).

Per query, gallery entries of the same pid AND the same camera are
discarded; in ``respect_camids`` mode gallery camids are sets (centroid
camera combinations) given as int64 bitmasks and the test is membership.
Queries with no remaining positive are dropped from the averages; CMC is
the rank of the first hit among the kept entries; AP is the mean of the
precision at each hit; top-k flags for k in ``K_LIST``.

The algebra runs on the device of ``indices`` in the reference's dtypes:
int32 ranks and counts, fp32 precision and AP. The bitmasks stay one int64
word here and in the streaming evaluator (torch shifts int64 on every
device), so cameras >= 31 test their own bit; the reference splits them
into two int32 words (``split_camid_words``) only because JAX without x64
truncates int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

K_LIST = (1, 5, 10, 20, 50)


class ReidMetrics(NamedTuple):
    cmc: np.ndarray          # [max_rank] CMC curve
    mAP: float
    all_topk: np.ndarray     # top-k accuracy for K_LIST
    single_performance: np.ndarray  # [num_valid_q, 3] (q_idx, q_pid, AP)


def _ranked_metrics(indices, q_pids, g_pids, q_camids, g_camids,
                    max_rank: int, respect_camids: bool):
    """The mask algebra over the [Q, G] ranked gallery order."""
    g_pids_ord = g_pids[indices]                       # [Q, G]
    cam_ord = g_camids[indices]
    matches = g_pids_ord == q_pids[:, None]
    if respect_camids:
        in_set = ((cam_ord >> q_camids[:, None]) & 1).bool()
        remove = matches & in_set
    else:
        remove = matches & (cam_ord == q_camids[:, None])
    keep = ~remove

    hit = matches & keep
    pos = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1  # rank among kept
    sentinel = torch.iinfo(torch.int32).max
    first_rank = torch.where(hit, pos, sentinel).amin(dim=1)
    valid_q = hit.any(dim=1)
    n_valid = valid_q.sum(dtype=torch.int32).clamp_min(1)

    ranks = torch.arange(max_rank, dtype=torch.int32, device=indices.device)
    cmc_hits = (first_rank[:, None] <= ranks[None, :]) & valid_q[:, None]
    cmc = cmc_hits.sum(dim=0, dtype=torch.int32) / n_valid

    cum_hits = torch.cumsum(hit, dim=1, dtype=torch.int32)
    prec = cum_hits / (pos + 1).clamp_min(1)
    num_rel = hit.sum(dim=1, dtype=torch.int32)
    ap = torch.where(hit, prec, 0.0).sum(dim=1) / num_rel.clamp_min(1)
    mAP = torch.where(valid_q, ap, 0.0).sum() / n_valid

    topk = torch.stack([((first_rank < kk) & valid_q).sum(dtype=torch.int32)
                        / n_valid for kk in K_LIST])
    return cmc, mAP, topk, ap, valid_q


def _as_int64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def eval_func(indices, q_pids, g_pids, q_camids, g_camids,
              max_rank: int = 50, respect_camids: bool = False) -> ReidMetrics:
    """``indices``: the [Q, G] argsorted gallery order (a tensor, on the
    device the algebra runs on, or an array, run on the CPU).

    With ``respect_camids``, ``g_camids`` holds an integer bitmask per
    gallery entry (bit c set <=> camera c contributed to that centroid) and
    ``q_camids`` plain camera ids."""
    indices = torch.as_tensor(indices)
    dev = indices.device
    num_g = indices.shape[1]
    if num_g < max_rank:
        max_rank = num_g
        print(f"Note: number of gallery samples is quite small, got {num_g}")
    cmc, mAP, topk, ap, valid_q = _ranked_metrics(
        indices.long(), _as_int64(q_pids, dev), _as_int64(g_pids, dev),
        _as_int64(q_camids, dev), _as_int64(g_camids, dev), max_rank,
        bool(respect_camids))
    ap = ap.cpu().numpy()
    q_idx = np.nonzero(valid_q.cpu().numpy())[0]
    single = np.stack(
        [q_idx, np.asarray(q_pids)[q_idx], ap[q_idx]], axis=1
    ) if q_idx.size else np.zeros((0, 3))
    return ReidMetrics(cmc=cmc.cpu().numpy(), mAP=float(mAP),
                       all_topk=topk.cpu().numpy(), single_performance=single)


def camid_sets_to_bitmask(camid_sets) -> np.ndarray:
    """[[camids...]] -> int64 bitmasks (cameras are small ints, <= 62)."""
    out = np.zeros(len(camid_sets), np.int64)
    for i, cams in enumerate(camid_sets):
        m = 0
        for c in np.atleast_1d(cams):
            m |= 1 << int(c)
        out[i] = m
    return out
