"""Gallery-sharded retrieval over a ``Mesh`` (counterpart of
``centroids_reid_tpu/parallel/retrieval.py``).

Gallery rows are sharded over the mesh; each shard selects its own top-k
(per-shard scores, the hierarchical top-k on K3), the n x k candidates per
query are copied to the mesh's first device, and one small exact top-k
merges them. No [Q, G] tensor exists on any device.

Where the JAX package runs one ``shard_map`` program, this is one process
driving its devices in turn: every shard's work is enqueued (each under
its own device, since the kernels launch on the current card's stream)
before any candidate is copied, so on several cards the shards run
concurrently. Shards that share a card run one after another on its
stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses.distances import _mm
from ..ops.retrieval import (
    _Q_TILE,
    _SCORE_BUDGET_BYTES,
    _exact_topk,
    _finalize_distances,
    _hier_topk_build,
    _pad_rows,
    scores,
)
from .mesh import Mesh, on_device, shard_width, split_rows

# rows per shard are a multiple of K1's 128-row gallery tile
SHARD_ALIGN = 128


def _shard_scores(q, g, gn):
    """``gn - 2 q.g`` in fp32 for one shard: K1 on a bf16 shard (queries
    padded to its 128-row tile), else the fp32 product with TF32 off (the
    JAX package's ``Precision.HIGHEST``)."""
    if g.dtype == torch.bfloat16:
        b = q.shape[0]
        return scores(_pad_rows(q.to(torch.bfloat16), (-b) % _Q_TILE), g,
                      gn)[:b]
    return gn - 2.0 * _mm(q.float(), g.float())


def shard_select_merge(mesh: Mesh, qf, shards, gns, k_eff: int,
                       width: int, rescore=None):
    """The shard-local selection and global merge, shared by
    ``sharded_topk`` and ``RetrievalService``'s sharded ranking.

    ``shards[s]`` ([width, D], bf16 or fp32) and ``gns[s]`` ([1, width]
    fp32, +inf on pad rows) live on ``mesh.devices[s]``. Per shard: the
    scores ``gn - 2 q.g``, the hierarchical top-``min(k_eff, width)``,
    the optional ``rescore(s, val, idx) -> val`` hook (the service
    re-scores winners in exact fp32 against the shard's own rows), and
    the global row offset ``s * width``. Then the candidates go to the
    first device and one exact top-``k_eff`` merges them, ties to the
    lower position in shard-major order (``lax.top_k``'s rule). Exact
    because every global top-k row is inside its own shard's top-k at
    scoring resolution. Returns ``(values, indices)`` [Q, k_eff] on the
    first device."""
    k_local = min(k_eff, width)
    vals, idxs = [], []
    for s, (dev, g, gn) in enumerate(zip(mesh.devices, shards, gns)):
        with on_device(dev):
            val, idx = _hier_topk_build(_shard_scores(qf.to(dev), g, gn),
                                        k_local)
            if rescore is not None:
                val = rescore(s, val, idx)
            vals.append(val)
            idxs.append(idx + s * width)
    home = mesh.devices[0]
    with on_device(home):
        allv = torch.cat([v.to(home) for v in vals], dim=1)
        alli = torch.cat([i.to(home) for i in idxs], dim=1)
        val, sel = _exact_topk(allv, k_eff)
        return val, torch.gather(alli, 1, sel)


def make_sharded_row_gather(mesh: Mesh, width: int):
    """Cross-shard row gather: ``gather(idx, shards)`` takes global row
    indices ``idx [Q, R]`` and the shards of ``shard_select_merge``'s
    layout, and returns their fp32 rows ``[Q, R, D]`` on the mesh's first
    device, equal to the unsharded ``gf32[idx]`` bit for bit. Each shard
    takes the indices in its range, and the first device keeps each
    shard's rows where that shard holds the index (the JAX package sums
    zero rows instead). Used by the sharded re-ranked serving path, whose
    windowed core needs its candidates' feature rows."""

    def gather(idx, shards):
        parts = []
        for s, (dev, g) in enumerate(zip(mesh.devices, shards)):
            with on_device(dev):
                li = idx.to(dev) - s * width
                ok = (li >= 0) & (li < width)
                parts.append((ok, g[li.clamp(0, width - 1)].float()))
        home = mesh.devices[0]
        with on_device(home):
            out = torch.zeros((*idx.shape, shards[0].shape[1]),
                              dtype=torch.float32, device=home)
            for ok, rows in parts:
                out = torch.where(ok.to(home)[..., None], rows.to(home), out)
            return out

    return gather


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor stays on its device; an array goes to ``device``."""
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.asarray(x)).to(device)


def sharded_topk_tensors(qf, gf, k: int, mesh: Mesh,
                         dist: str = "euclidean"):
    """``sharded_topk`` with its results left on the mesh's first device:
    (distances fp32 [Q, k], indices int64 [Q, k])."""
    home = mesh.devices[0]
    qf = _as_tensor(qf, home).to(home)
    gf = _as_tensor(gf, home)
    g = gf.shape[0]
    k_eff = min(k, g)
    if dist == "cosine":
        in_dtype = qf.dtype
        qf32, gf32 = qf.float(), gf.float()
        qf = (qf32 / qf32.norm(dim=1, keepdim=True).clamp_min(1e-12)
              ).to(in_dtype)
        gf = (gf32 / gf32.norm(dim=1, keepdim=True).clamp_min(1e-12)
              ).to(in_dtype)
        gn = torch.ones(g, device=gf.device)
    elif dist == "euclidean":
        gn = (gf.float() * gf.float()).sum(dim=1)
    else:
        raise ValueError(f"Unknown distance {dist!r}")
    width = shard_width(g, len(mesh.devices), SHARD_ALIGN)
    shards = split_rows(gf, mesh, width)
    gns = [x[None, :] for x in split_rows(gn, mesh, width, float("inf"))]
    # queries in chunks, so that a shard's fp32 scores stay within the score
    # budget; a shard may hold fewer than k real rows, and the merge still
    # sees >= k_eff finite candidates because shards x real rows >= G
    chunk = max(_Q_TILE, _SCORE_BUDGET_BYTES // (width * 4) // _Q_TILE
                * _Q_TILE)
    parts = [shard_select_merge(mesh, qf[s:s + chunk], shards, gns, k_eff,
                                width) for s in range(0, qf.shape[0], chunk)]
    with on_device(home):
        return _finalize_distances(torch.cat([v for v, _ in parts]),
                                   torch.cat([i for _, i in parts]), qf,
                                   dist)


def sharded_topk(qf, gf, k: int, mesh: Mesh, dist: str = "euclidean"):
    """Top-k over a gallery sharded on ``mesh``: ``qf [Q, D]``, ``gf [G,
    D]`` (arrays, or tensors on any device; rows padded to a multiple of
    128 x shards, pad rows never win; queries in chunks that keep each
    shard's fp32 scores within ``ops.retrieval``'s budget). Returns
    (distances [Q, k], indices [Q, k]) as numpy arrays, in the distance
    flavour of ``ops.retrieval.topk_retrieval``. The values are the
    selection scores: bf16 products for bf16 inputs (K1), exact fp32
    otherwise."""
    val, idx = sharded_topk_tensors(qf, gf, k, mesh, dist)
    return val.cpu().numpy(), idx.cpu().numpy()
