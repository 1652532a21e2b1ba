"""Batch-hard triplet loss with masks (counterpart of
``centroids_reid_tpu/losses/triplet.py``).

* hard mining: per anchor, the largest distance to a same-label entry
  (itself included) and the smallest to a different-label one;
* ``margin``: ``mean(relu(d_ap - d_an + margin))``; ``margin=None``:
  ``mean(softplus(d_ap - d_an))``;
* ``anchor_mask`` drops anchors from the mean AFTER mining, so masked
  entries stay mining candidates (the query triplet over mock slots);
* ``candidate_mask`` removes entries before mining: they are neither
  anchors nor candidates (the CTL centroid triplet).

The maximum and minimum are ``amax`` / ``amin``, which share the gradient
evenly among tied entries as JAX's ``max`` / ``min`` do (mock slots are
identical all-zero images, so their distances tie exactly). Every function
takes leading batch dimensions: ``dist`` [..., N, N], masks [..., N].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .distances import get_dist_func, l2_normalize


def batch_hard_mine(dist, labels, candidate_mask=None):
    """dist [..., N, N], labels [N] -> (dist_ap, dist_an), each [..., N].
    Entries outside ``candidate_mask`` are never chosen."""
    same = labels[:, None] == labels[None, :]
    is_pos, is_neg = same, ~same
    if candidate_mask is not None:
        cand = candidate_mask[..., None, :]
        is_pos = is_pos & cand
        is_neg = is_neg & cand
    dist_ap = torch.where(is_pos, dist, float("-inf")).amax(dim=-1)
    dist_an = torch.where(is_neg, dist, float("inf")).amin(dim=-1)
    return dist_ap, dist_an


def masked_mean(x, mask, dim=None):
    """Mean of ``x`` over ``mask`` (all of ``x`` when None); an empty mask
    gives 0."""
    if mask is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    if dim is None:
        return torch.where(mask, x, 0.0).sum() / mask.sum().clamp_min(1)
    return (torch.where(mask, x, 0.0).sum(dim=dim)
            / mask.sum(dim=dim).clamp_min(1))


def triplet_from_dist(dist, labels, margin: Optional[float] = 0.5,
                      anchor_mask=None, candidate_mask=None):
    """The loss of ``triplet_loss`` from a distance matrix [..., N, N]:
    (loss [...], dist_ap [..., N], dist_an [..., N])."""
    dist_ap, dist_an = batch_hard_mine(dist, labels, candidate_mask)
    valid = anchor_mask
    if candidate_mask is not None:
        valid = candidate_mask if valid is None else valid & candidate_mask
    # rows with no candidate hold +-inf: keep them out of the arithmetic
    if valid is not None:
        safe_ap = torch.where(valid, dist_ap, 0.0)
        safe_an = torch.where(valid, dist_an, 1.0)
    else:
        safe_ap, safe_an = dist_ap, dist_an
    if margin is not None:
        per_anchor = F.relu(safe_ap - safe_an + margin)
    else:
        per_anchor = F.softplus(safe_ap - safe_an)
    loss = masked_mean(per_anchor, valid, dim=-1 if dist.dim() > 2 else None)
    return loss, dist_ap, dist_an


def triplet_loss(feats, labels, margin: Optional[float] = 0.5,
                 dist_func: str = "euclidean", anchor_mask=None,
                 candidate_mask=None, normalize_feature: bool = False):
    """Batch-hard triplet loss over feats [N, D]. Returns (loss, dist_ap,
    dist_an); the per-anchor distances of invalid anchors hold junk (reduce
    them through the masks)."""
    if normalize_feature:
        feats = l2_normalize(feats)
    dist = get_dist_func(dist_func)(feats, feats)
    return triplet_from_dist(dist, labels, margin, anchor_mask,
                             candidate_mask)
