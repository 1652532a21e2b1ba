"""Pairwise distances, eval flavours (counterpart of the eval half of
``centroids_reid_tpu/losses/distances.py``).

* squared euclidean, no sqrt: ``||x||^2 + ||y||^2 - 2 x.y``, the ranking
  distance of the reference's eval metric (argsort order equals that of the
  euclidean distance);
* cosine distance: ``|1 - cos|`` clamped to ``>= eps``.

Always fp32 with TF32 off for the product: the reference's eval is exact
fp32 (``Precision.HIGHEST``), and bf16 is too coarse to rank.
"""

from __future__ import annotations

import torch


def _mm(x, y):
    """fp32 ``x @ y.T`` with TF32 off whatever the global switch says."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ y.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def squared_euclidean_dist(x, y):
    """[m, d], [n, d] -> [m, n] squared euclidean distances."""
    x, y = x.float(), y.float()
    xx = (x * x).sum(dim=1, keepdim=True)
    yy = (y * y).sum(dim=1, keepdim=True)
    return xx + yy.T - 2.0 * _mm(x, y)


def cosine_sim(x, y, eps: float = 1e-12):
    x, y = x.float(), y.float()
    xn = x.norm(dim=1, keepdim=True).clamp_min(eps)
    yn = y.norm(dim=1, keepdim=True).clamp_min(eps)
    return _mm(x / xn, y / yn)


def cosine_dist(x, y, eps: float = 1e-12):
    return (1.0 - cosine_sim(x, y, eps)).abs().clamp_min(eps)


_EVAL_DIST_FUNCS = {
    "euclidean": squared_euclidean_dist,
    "cosine": cosine_dist,
}


def get_dist_func(name: str = "euclidean", eval_mode: bool = True):
    """The eval distance ``name``. Only the eval flavours are ported: the
    training flavours (euclidean with sqrt) come with CTL training."""
    if not eval_mode:
        raise NotImplementedError(
            "the training distances are not ported yet; see ROADMAP.md "
            "queue 1 (training)")
    if name not in _EVAL_DIST_FUNCS:
        raise ValueError(f"Unknown distance function {name!r}")
    return _EVAL_DIST_FUNCS[name]
