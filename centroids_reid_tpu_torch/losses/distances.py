"""Pairwise distances (counterpart of
``centroids_reid_tpu/losses/distances.py``).

* training euclidean: ``sqrt(clamp(||x||^2 + ||y||^2 - 2 x.y, 1e-12))``;
* eval euclidean: the squared distance without the sqrt, the ranking
  distance of the reference's eval metric (argsort order equals that of the
  euclidean distance);
* cosine distance (both): ``|1 - cos|`` clamped to ``>= eps``.

Every function takes ``[..., m, d]`` and ``[..., n, d]`` and returns
``[..., m, n]``. Always fp32 with TF32 off for the product: the reference's
eval is exact fp32 (``Precision.HIGHEST``), and bf16 is too coarse to rank.
"""

from __future__ import annotations

import torch


def _mm(x, y):
    """fp32 ``x @ y^T`` with TF32 off whatever the global switch says."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ y.transpose(-1, -2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def as_float(x):
    """fp32 for lower-precision inputs; fp32 and fp64 pass unchanged, so a
    float64 step stays float64."""
    return x if x.dtype == torch.float64 else x.float()


def squared_euclidean_dist(x, y):
    """[..., m, d], [..., n, d] -> [..., m, n] squared euclidean distances."""
    x, y = as_float(x), as_float(y)
    xx = (x * x).sum(dim=-1, keepdim=True)
    yy = (y * y).sum(dim=-1, keepdim=True)
    return xx + yy.transpose(-1, -2) - 2.0 * _mm(x, y)


def euclidean_dist(x, y):
    """[..., m, d], [..., n, d] -> [..., m, n] euclidean distances (the
    training flavour: the root of the clamped squared distance)."""
    return squared_euclidean_dist(x, y).clamp_min(1e-12).sqrt()


def cosine_sim(x, y, eps: float = 1e-12):
    x, y = as_float(x), as_float(y)
    xn = x.norm(dim=-1, keepdim=True).clamp_min(eps)
    yn = y.norm(dim=-1, keepdim=True).clamp_min(eps)
    return _mm(x / xn, y / yn)


def cosine_dist(x, y, eps: float = 1e-12):
    return (1.0 - cosine_sim(x, y, eps)).abs().clamp_min(eps)


def l2_normalize(x, eps: float = 1e-12):
    """Unit-norm rows; eps is added to the norm, as the reference does."""
    return x / (x.norm(dim=-1, keepdim=True) + eps)


_DIST_FUNCS = {
    "euclidean": euclidean_dist,
    "cosine": cosine_dist,
}

_EVAL_DIST_FUNCS = {
    "euclidean": squared_euclidean_dist,
    "cosine": cosine_dist,
}


def get_dist_func(name: str = "euclidean", eval_mode: bool = False):
    """The training distance ``name``, or its eval flavour."""
    table = _EVAL_DIST_FUNCS if eval_mode else _DIST_FUNCS
    if name not in table:
        raise ValueError(f"Unknown distance function {name!r}")
    return table[name]
