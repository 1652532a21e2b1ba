"""Centroid Triplet Loss (CTL), all K leave-one-slot-out rounds at once
(counterpart of ``centroids_reid_tpu/losses/centroid.py``).

The batch is P pids x K instance slots, pid-major, mock slots at the tail
of each pid's K. In round ``i`` the queries are every pid's slot ``i``, and
pid ``c``'s centroid is the mean of its real instances in the other slots;
a pid whose slot ``i`` is a mock drops out of the round. The triplet loss
runs over ``concat(queries, centroids)`` with the pid labels twice and the
invalid entries removed before mining; a round with fewer than two valid
pids is skipped, and the loss is the mean over the rounds kept.

The K rounds are one batched problem of static shape ([K, 2P, 2P]
distances, masks instead of compaction), with no Python loop over rounds.
"""

from __future__ import annotations

from typing import Optional

import torch

from .distances import as_float, get_dist_func
from .triplet import masked_mean, triplet_from_dist


def ctl_centroid_loss(features, labels, is_real, num_instances: int,
                      margin: Optional[float] = 0.5,
                      dist_func: str = "euclidean"):
    """features [P*K, D] pid-major, labels [P*K], is_real [P*K] bool.

    Returns dict(loss, dist_ap, dist_an, l2_mean_centroid, valid_rounds);
    ``loss`` is unweighted (the caller applies
    ``CENTROID_CONTRASTIVE_WEIGHT``)."""
    pk, d = features.shape
    k = num_instances
    p = pk // k
    f = as_float(features).reshape(p, k, d)
    r = is_real.reshape(p, k)
    pid_labels = labels.reshape(p, k)[:, 0]

    # leave-one-out masked means as total minus slot
    rf = torch.where(r[..., None], f, 0.0)
    tot_sum = rf.sum(dim=1)                                   # [P, D]
    tot_cnt = r.sum(dim=1)                                    # [P]
    loo_sum = tot_sum[None] - rf.transpose(0, 1)              # [K, P, D]
    loo_cnt = tot_cnt[None] - r.T.to(tot_cnt.dtype)           # [K, P]
    centroids = loo_sum / loo_cnt.clamp_min(1)[..., None]

    queries = f.transpose(0, 1)                               # [K, P, D]
    validity = r.T                                            # [K, P]
    emb = torch.cat([queries, centroids], dim=1)              # [K, 2P, D]
    labs = torch.cat([pid_labels, pid_labels])
    cand = torch.cat([validity, validity], dim=1)             # [K, 2P]
    dist = get_dist_func(dist_func)(emb, emb)
    losses, dap, dan = triplet_from_dist(dist, labs, margin,
                                         candidate_mask=cand)
    with torch.no_grad():
        daps = masked_mean(dap, cand, dim=1)
        dans = masked_mean(torch.where(torch.isfinite(dan), dan, 0.0), cand,
                           dim=1)
        l2s = masked_mean(centroids.norm(dim=-1), validity, dim=1)

    round_valid = validity.sum(dim=1) > 1                     # [K]
    n_rounds = round_valid.sum().clamp_min(1)

    def round_mean(x):
        return torch.where(round_valid, x, 0.0).sum() / n_rounds

    return {
        "loss": round_mean(losses),
        "dist_ap": round_mean(daps),
        "dist_an": round_mean(dans),
        "l2_mean_centroid": round_mean(l2s),
        "valid_rounds": round_valid.sum(),
    }
