"""Streaming CMC / mAP / top-k: evaluation where the [Q, G] distance matrix
cannot exist (counterpart of ``centroids_reid_tpu/metrics/streaming_eval.py``).

mAP, CMC and top-k need only each positive's rank, and a positive's rank
among the kept gallery entries is the COUNT of kept entries ordered
strictly before it by (distance, index), the order a stable argsort gives.
So the whole metric is two passes over the gallery on the evaluator's
device, with O(Q * H) state (H = the most positives a query has), each one
launch of the distance-and-rank kernel K7 per gallery shard
(``ops/stream_rank.py``) over the whole query set:

1. *extract*: each positive's distance, computed in the kernel exactly as
   the count computes it (one thread's fp32 FFMA chain over D in order),
   so it is bit for bit the value the count pass compares against;
2. *count*: each query's positives are sorted by the int64 key
   ``order_key(d, j) = mono32(d) * 2^32 + j`` (-0.0 folded to +0.0, as
   float comparison equates them). A kept entry whose key is not below the
   query's farthest positive precedes none (one compare, almost every
   entry); any other adds one to a [Q, H] histogram at its position among
   the sorted keys, and the inclusive prefix sum of the histogram, mapped
   back to the positives' order, is ``rank[q, h] = #{kept j : (d_qj, j) <
   (d_pos, pos_idx)}``. A positive's own key is not below itself, so it
   never counts itself.

The rows' norms (squared, or inverse for cosine) are made once per
evaluation per shard, a tile at a time; the rows are read where they lie,
with no second copy, and the passes keep nothing of size [Q, G] or [Q, H,
G]: device memory is flat in H (a pid-heavy gallery). On CPU tensors the
kernel's plain versions run the same rule in torch over score tiles of
``g_chunk`` gallery rows.

From the ranks the Market-1501 metrics are closed-form on the host:
``first_rank = min_h rank`` gives CMC and top-k, and the precision at hit h
is ``(hrank_h + 1) / (rank_h + 1)`` with ``hrank`` the hit's rank among the
query's hits; AP is their mean over the hits.

Camid bitmasks stay one int64 word (torch shifts int64 on every device);
the reference splits them into two int32 words only because JAX without
x64 truncates int64. Ranks are int32, as in the reference, so galleries of
2^31 rows or more are out of scope.

``mesh`` shards the gallery rows over its devices (``parallel/``): shard
``s`` holds rows ``s * width ..`` (``width`` a whole number of ``g_chunk``
tiles) and is placed once. Every shard extracts against its own rows with
its global offset, the extractions are summed on the mesh's first device
(a hit lives in exactly one shard, the others give 0) before any shard
counts, and the shards' histograms are summed there. Without a mesh the
device of the gallery is the one shard.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.rerank import _as_f32
from ..ops.stream_rank import (
    order_key,
    prepare_rows,
    stream_count,
    stream_extract,
)
from ..parallel.mesh import on_device, shard_width
from ..utils.profiling import annotate, count
from .eval_reid import K_LIST, ReidMetrics

_G_CHUNK = 8192    # gallery rows per plain score tile; shards hold whole tiles
_H_CHUNK = 64      # H is padded to whole multiples, the JAX package's tiles
_NEVER = torch.iinfo(torch.int64).max   # the key of a padded positive slot


def _positives_table(q_pids, g_pids, q_camids, g_camids,
                     respect_camids: bool) -> np.ndarray:
    """[Q, H] gallery indices of each query's hits (same pid, kept under the
    camid-removal rule), ascending, -1 padded; H is padded to whole
    ``_H_CHUNK`` tiles, as the JAX package's table. With ``respect_camids``
    the gallery camids are bitmasks and removal is set membership.

    Vectorised over a stable sort of the gallery pids: each query's
    candidates are its pid's run of that order (ascending indices), laid
    end to end in one flat array, so memory is O(candidates) however the
    pids are spread."""
    q_pids = np.asarray(q_pids, np.int64)
    g_pids = np.asarray(g_pids, np.int64)
    q_camids = np.asarray(q_camids, np.int64)
    g_camids = np.asarray(g_camids, np.int64)
    order = np.argsort(g_pids, kind="stable")
    sorted_pids = g_pids[order]
    lo = np.searchsorted(sorted_pids, q_pids, "left")
    n = np.searchsorted(sorted_pids, q_pids, "right") - lo
    # query row of each candidate, and its place in ``order``: lo of its
    # query plus its offset within the query's run
    row = np.repeat(np.arange(len(q_pids)), n)
    cand = order[np.arange(row.size) + np.repeat(lo - (np.cumsum(n) - n), n)]
    if respect_camids:
        keep = ((g_camids[cand] >> q_camids[row]) & 1) == 0
    else:
        keep = g_camids[cand] != q_camids[row]
    row, cand = row[keep], cand[keep]
    hits = np.bincount(row, minlength=len(q_pids))
    h = max(int(hits.max(initial=0)), 1)
    h += (-h) % _H_CHUNK
    pos = np.full((len(q_pids), h), -1, np.int32)
    col = np.arange(row.size) - np.repeat(np.cumsum(hits) - hits, hits)
    pos[row, col] = cand
    return pos


class _Rows(NamedTuple):
    """Rows as the kernel reads them on ``device``, with ``prepare_rows``'s
    norms, pids and cameras (int64); a gallery shard's global offset
    ``j0``."""

    device: torch.device
    j0: int
    x: torch.Tensor
    norms: torch.Tensor
    pids: torch.Tensor
    cams: torch.Tensor


def _placed(x, pids, cams, device, dist: str, g_chunk: int,
            j0: int = 0) -> _Rows:
    x = x.to(device)
    return _Rows(device, j0, x, prepare_rows(x, dist, g_chunk),
                 torch.as_tensor(np.asarray(pids, np.int64), device=device),
                 torch.as_tensor(np.asarray(cams, np.int64), device=device))


def _shards(gf, g_pids, g_camids, devices, g_chunk: int, dist: str) -> list:
    """The gallery cut into ``len(devices)`` blocks of whole ``g_chunk``
    tiles, each placed on its device once (a view where the rows are
    already there); shards past the last row hold none."""
    num_g = gf.shape[0]
    width = shard_width(num_g, len(devices), g_chunk)
    out = []
    for s, dev in enumerate(devices):
        lo, hi = min(s * width, num_g), min((s + 1) * width, num_g)
        out.append(_placed(gf[lo:hi], g_pids[lo:hi], g_camids[lo:hi], dev,
                           dist, g_chunk, j0=s * width))
    return out


def _summed(parts: list, home: torch.device) -> torch.Tensor:
    out = parts[0].to(home)
    for p in parts[1:]:
        out = out + p.to(home)
    return out


def _each_shard(fn, queries: _Rows, shards: list, *per_query, **kw):
    """``fn`` over every shard, the queries and ``per_query`` tensors moved
    to its device, summed on the queries' device; every shard's launch is
    enqueued before any result is gathered."""
    q, parts = queries, []
    for sh in shards:
        dev = sh.device
        with on_device(dev):
            parts.append(fn(
                q.x.to(dev), q.norms.to(dev),
                sh.x, sh.norms, q.pids.to(dev), sh.pids, q.cams.to(dev),
                sh.cams, *[t.to(dev) for t in per_query], j0=sh.j0, **kw))
    with on_device(queries.device):
        return _summed(parts, queries.device)


class StreamRanks(NamedTuple):
    """Per-hit rank state from the two streaming passes (host arrays)."""

    pos: np.ndarray       # [Q, H] gallery index of each hit, -1 padded
    dpos: np.ndarray      # [Q, H] fp32 each hit's extracted distance
    ranks: np.ndarray     # [Q, H] int32 hit's rank among KEPT entries
    num_rel: np.ndarray   # [Q] number of hits per query


def compute_stream_ranks(qf, gf, q_pids, g_pids, q_camids, g_camids,
                         respect_camids: bool = False,
                         dist: str = "euclidean", mesh=None,
                         g_chunk: int = _G_CHUNK,
                         device="cuda") -> StreamRanks:
    """The two streaming passes over the whole query set; returns host
    arrays: each hit's gallery index, distance and rank among the kept
    entries. The passes run on the device of ``gf`` when it is a tensor
    (a gallery on the card is never copied to the host), else on
    ``device``; with ``mesh``, on its devices, the gallery's shards copied
    there from wherever it lies (a host array goes straight to them).

    Under a running profiler it records the spans ``eval.positives``,
    ``eval.place``, ``eval.extract``, ``eval.count`` and ``eval.to_host``
    (one each), and counts, from host values: ``eval.pairs_compared``
    (the pairs the count orders: real hits x gallery rows scanned) and
    ``eval.pairs_useful`` (hits x G), equal since no hit slot or row is
    padded, ``eval.entries_searched`` (the
    kept entries under each query's farthest hit, which went to the
    search: the sum of the farthest hits' ranks) and
    ``eval.entries_scanned`` (Q x G)."""
    if mesh is None:
        gf = _as_f32(gf, device)
        devices = (gf.device,)
    else:
        gf = (gf.float() if torch.is_tensor(gf)
              else torch.from_numpy(np.asarray(gf, np.float32)))
        devices = mesh.devices
    dev = devices[0]
    qf = _as_f32(qf, dev).to(dev)
    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    q_camids = np.asarray(q_camids)
    g_camids = np.asarray(g_camids)
    num_q, num_g = qf.shape[0], gf.shape[0]

    with annotate("eval.positives"):
        pos = _positives_table(q_pids, g_pids, q_camids, g_camids,
                               respect_camids)
    num_rel = (pos >= 0).sum(axis=1)
    with annotate("eval.place"):
        shards = _shards(gf, g_pids, g_camids, devices, g_chunk, dist)
        queries = _placed(qf, q_pids, q_camids, dev, dist, g_chunk)
        pos_d = torch.as_tensor(pos.astype(np.int64), device=dev)
        rel_d = torch.as_tensor(num_rel.astype(np.int32), device=dev)
    kw = dict(dist=dist, respect_camids=respect_camids, g_chunk=g_chunk)

    with annotate("eval.extract"):
        dpos = _each_shard(stream_extract, queries, shards, pos_d, rel_d,
                           **kw)
    with annotate("eval.count"):
        real = pos_d >= 0
        keys, order = torch.where(real, order_key(dpos, pos_d),
                                  _NEVER).sort(dim=1)
        hist = _each_shard(stream_count, queries, shards, keys, rel_d, **kw)
        ranks = torch.zeros_like(hist).scatter_(
            1, order, hist.cumsum(dim=1, dtype=torch.int32))
        ranks = torch.where(real, ranks, 0)
    with annotate("eval.to_host"):
        dpos = dpos.cpu().numpy()
        ranks = ranks.cpu().numpy()
        hits = int(num_rel.sum())
        count("eval.pairs_compared", hits * num_g)
        count("eval.pairs_useful", hits * num_g)
        count("eval.entries_searched",
              int(ranks.max(axis=1, initial=0).sum()))
        count("eval.entries_scanned", num_q * num_g)
    return StreamRanks(pos=pos, dpos=dpos, ranks=ranks, num_rel=num_rel)


def _hrank_lexsort(pos: np.ndarray, dpos: np.ndarray) -> np.ndarray:
    """hrank[q, h]: hit h's rank among query q's hits by (distance, index),
    the stable-argsort tie order; padded slots sort last."""
    hvalid = pos >= 0
    d_key = np.where(hvalid, dpos, np.inf)
    i_key = np.where(hvalid, pos, np.iinfo(np.int32).max)
    order = np.lexsort((i_key, d_key), axis=-1)
    hrank = np.empty(pos.shape, np.int64)
    np.put_along_axis(
        hrank, order, np.broadcast_to(np.arange(pos.shape[1]), pos.shape),
        axis=1)
    return hrank


def _metrics_from_ranks(pos: np.ndarray, ranks: np.ndarray,
                        hrank: np.ndarray, num_rel: np.ndarray,
                        q_pids: np.ndarray, max_rank: int) -> ReidMetrics:
    """Closed-form Market-1501 metrics from per-hit ranks (host, O(Q * H)):
    ``ranks`` is each hit's rank among the query's kept entries, ``hrank``
    its rank among the query's hits."""
    hvalid = pos >= 0
    big = np.int64(np.iinfo(np.int32).max)
    first_rank = np.where(hvalid, ranks, big).min(axis=1)
    valid_q = num_rel > 0
    n_valid = max(int(valid_q.sum()), 1)

    prec = np.where(hvalid, (hrank + 1) / np.maximum(ranks + 1, 1), 0.0)
    ap = prec.sum(axis=1) / np.maximum(num_rel, 1)

    ranks_axis = np.arange(max_rank)
    cmc = (((first_rank[:, None] <= ranks_axis[None, :]) & valid_q[:, None])
           .sum(axis=0) / n_valid)
    mAP = float(ap[valid_q].sum() / n_valid)
    topk = np.array(
        [((first_rank < kk) & valid_q).sum() / n_valid for kk in K_LIST])
    q_idx = np.nonzero(valid_q)[0]
    single = np.stack(
        [q_idx, q_pids[q_idx], ap[q_idx]], axis=1
    ) if q_idx.size else np.zeros((0, 3))
    return ReidMetrics(cmc=cmc.astype(np.float64), mAP=mAP, all_topk=topk,
                       single_performance=single)


def _clamp_max_rank(max_rank: int, num_g: int) -> int:
    if num_g < max_rank:
        print(f"Note: number of gallery samples is quite small, got {num_g}")
        return num_g
    return max_rank


def eval_func_streaming(qf, gf, q_pids, g_pids, q_camids, g_camids,
                        max_rank: int = 50, respect_camids: bool = False,
                        dist: str = "euclidean", mesh=None,
                        g_chunk: int = _G_CHUNK,
                        device="cuda") -> ReidMetrics:
    """ReidMetrics from features (already normalised if ``TEST.FEAT_NORM``)
    without materialising [Q, G]; equal to ``eval_func`` on the stable
    argsort of the distance matrix, tie order included."""
    sr = compute_stream_ranks(qf, gf, q_pids, g_pids, q_camids, g_camids,
                              respect_camids=respect_camids, dist=dist,
                              mesh=mesh, g_chunk=g_chunk, device=device)
    max_rank = _clamp_max_rank(max_rank, len(gf))
    with annotate("eval.metrics"):
        return _metrics_from_ranks(sr.pos, sr.ranks,
                                   _hrank_lexsort(sr.pos, sr.dpos),
                                   sr.num_rel, np.asarray(q_pids), max_rank)


def _window_positions(ridx: np.ndarray, pos: np.ndarray,
                      num_g: int) -> np.ndarray:
    """For each hit ``pos[q, h]``, its position in query q's re-ranked
    window ``ridx[q, :]``, or -1 outside it: a per-row sort and one
    searchsorted over the keys ``row * (G + 1) + index``."""
    nq, r = ridx.shape
    base = np.arange(nq, dtype=np.int64)[:, None] * (num_g + 1)
    order = np.argsort(ridx, axis=1, kind="stable")
    sorted_idx = np.take_along_axis(ridx, order, axis=1)
    flat = (sorted_idx.astype(np.int64) + base).ravel()
    keys = (pos.astype(np.int64) + base).ravel()
    loc = np.searchsorted(flat, keys)
    found = (loc < flat.size) & (flat[np.minimum(loc, flat.size - 1)] == keys)
    loc = loc.reshape(nq, -1)
    found = found.reshape(nq, -1)
    local = np.clip(loc - np.arange(nq, dtype=np.int64)[:, None] * r,
                    0, r - 1)
    wpos = np.take_along_axis(order, local, axis=1)
    return np.where(found, wpos, -1)


def eval_func_streaming_reranked(qf, gf, q_pids, g_pids, q_camids, g_camids,
                                 r: int = 500, k1: int = 20, k2: int = 6,
                                 lambda_value: float = 0.3,
                                 max_rank: int = 50,
                                 respect_camids: bool = False,
                                 dist: str = "euclidean", mesh=None,
                                 g_chunk: int = _G_CHUNK,
                                 device="cuda") -> ReidMetrics:
    """Streaming metrics under windowed k-reciprocal re-ranking
    (``ops.rerank.rerank_topk``), at any gallery size.

    Per query, positions 0..r-1 are the re-ranked top-r window and
    positions r.. keep the original (distance, index) order. A hit outside
    the window keeps its streaming rank and hit rank (the window is a
    permutation of the original top r, so it precedes every tail entry in
    both orders); a hit inside takes rank = the kept window entries before
    its re-ranked position, and hit rank = the window hits before it.

    With ``r >= G`` the result is the windowed re-ranked order of the
    whole gallery. Ties between re-ranked values resolve in window order.
    The stitching assumes the window is the first r entries of the stable
    order; two entries with bit-identical distances straddling rank r
    (duplicated gallery rows) may be chosen differently by the two
    selections, as in the reference."""
    from ..ops.rerank import rerank_topk

    q_pids = np.asarray(q_pids)
    g_pids = np.asarray(g_pids)
    q_camids = np.asarray(q_camids)
    g_camids = np.asarray(g_camids)
    # one copy of the gallery on the device (the mesh's first), for both
    # the passes and the window selection
    if mesh is not None:
        device = mesh.devices[0]
    gf = _as_f32(gf, device)
    qf = _as_f32(qf, gf.device).to(gf.device)
    sr = compute_stream_ranks(qf, gf, q_pids, g_pids, q_camids, g_camids,
                              respect_camids=respect_camids, dist=dist,
                              mesh=mesh, g_chunk=g_chunk)
    num_g = int(gf.shape[0])
    _, ridx = rerank_topk(qf, gf, r=r, k1=k1, k2=k2,
                          lambda_value=lambda_value, dist=dist, mesh=mesh)
    ridx = ridx.cpu().numpy()                   # [Q, r] re-ranked windows
    with annotate("eval.metrics"):
        wp = g_pids[ridx]
        match = wp == q_pids[:, None]
        if respect_camids:
            wc = g_camids[ridx].astype(np.int64)
            same = ((wc >> q_camids[:, None].astype(np.int64)) & 1) == 1
        else:
            same = g_camids[ridx] == q_camids[:, None]
        keep = ~(match & same)
        hit = match & keep
        kept_before = np.cumsum(keep, axis=1) - keep
        hits_before = np.cumsum(hit, axis=1) - hit

        win_pos = _window_positions(ridx, sr.pos, num_g)
        in_win = win_pos >= 0
        j = np.clip(win_pos, 0, ridx.shape[1] - 1)
        ranks = np.where(in_win, np.take_along_axis(kept_before, j, axis=1),
                         sr.ranks)
        hrank = np.where(in_win, np.take_along_axis(hits_before, j, axis=1),
                         _hrank_lexsort(sr.pos, sr.dpos))
        max_rank = _clamp_max_rank(max_rank, num_g)
        return _metrics_from_ranks(sr.pos, ranks, hrank, sr.num_rel, q_pids,
                                   max_rank)
