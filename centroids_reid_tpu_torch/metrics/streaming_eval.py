"""Streaming CMC / mAP / top-k: evaluation where the [Q, G] distance matrix
cannot exist (counterpart of ``centroids_reid_tpu/metrics/streaming_eval.py``).

mAP, CMC and top-k need only each positive's rank, and a positive's rank
among the kept gallery entries is the COUNT of kept entries ordered
strictly before it. Counting distributes over gallery chunks, so the whole
metric is two passes over [Qc, C] score tiles on the evaluator's device,
with O(Q * H) state (H = the most positives a query has):

1. *extract*: each positive's distance is read out of the score tile it
   lives in, so it is bit for bit the value the count pass compares
   against;
2. *count*: ``rank[q, h] = #{kept j : (d_qj, j) < (d_pos, pos_idx)}``,
   lexicographic on (distance, index), the order a stable argsort gives.

Both passes compute every tile with one function
(``get_dist_func(dist, eval_mode=True)``, as ``r1_map.compute_distmat_device``)
on one shape: the gallery is cut into tiles of ``g_chunk`` rows, and the
ragged last tile is a zero-padded copy of its own, made once, so that the
same matrix product runs in both passes (padded rows are never kept). The
passes are Python loops over tiles on the device; neither a tile nor the
rank state goes to the host inside them. The count compares int64 keys
``mono32(d) * 2^32 + j``: one comparison per (positive, entry) pair instead
of the reference's four, the same order (-0.0 is folded to +0.0 first, as
float comparison equates them). The positives axis is cut into tiles of
``_H_CHUNK``, so device memory stays flat in H (a pid-heavy gallery).

From the ranks the Market-1501 metrics are closed-form on the host:
``first_rank = min_h rank`` gives CMC and top-k, and the precision at hit h
is ``(hrank_h + 1) / (rank_h + 1)`` with ``hrank`` the hit's rank among the
query's hits; AP is their mean over the hits.

Camid bitmasks stay one int64 word (torch shifts int64 on every device);
the reference splits them into two int32 words only because JAX without
x64 truncates int64. Ranks are int32, as in the reference, so galleries of
2^31 rows or more are out of scope.

``mesh`` shards the gallery rows over its devices (``parallel/``): the
gallery is padded to ``g_chunk`` x shards rows and each shard is placed
once. Per query chunk every shard extracts against its own rows with its
global offset, the extractions are summed on the mesh's first device
(a hit lives in exactly one shard, the others give 0) before any shard
counts, and the shards' counts are summed there. Without a mesh the
device of the gallery is the one shard.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from ..losses.distances import get_dist_func
from ..ops.rerank import _as_f32
from ..parallel.mesh import on_device, shard_width
from ..utils.profiling import annotate, count
from .eval_reid import K_LIST, ReidMetrics

_G_CHUNK = 8192    # gallery rows per score tile
_Q_CHUNK = 128     # query rows per pass
_H_CHUNK = 64      # positives per compare tile: [Qc, _H_CHUNK, C] at most
_NEVER = torch.iinfo(torch.int64).max   # the key of an entry never counted


def _positives_table(q_pids, g_pids, q_camids, g_camids,
                     respect_camids: bool) -> np.ndarray:
    """[Q, H] gallery indices of each query's hits (same pid, kept under the
    camid-removal rule), -1 padded; H is padded to whole ``_H_CHUNK`` tiles.
    With ``respect_camids`` the gallery camids are bitmasks and removal is
    set membership."""
    by_pid = defaultdict(list)
    for j, p in enumerate(np.asarray(g_pids).tolist()):
        by_pid[int(p)].append(j)
    g_camids = np.asarray(g_camids)
    lists = []
    for qi in range(len(q_pids)):
        cand = by_pid.get(int(q_pids[qi]), [])
        qc = int(q_camids[qi])
        if respect_camids:
            hits = [j for j in cand if not ((int(g_camids[j]) >> qc) & 1)]
        else:
            hits = [j for j in cand if int(g_camids[j]) != qc]
        lists.append(hits)
    h = max([len(x) for x in lists] + [1])
    h += (-h) % _H_CHUNK
    pos = np.full((len(q_pids), h), -1, np.int32)
    for qi, x in enumerate(lists):
        pos[qi, :len(x)] = x
    return pos


def _order_key(d: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as the pairs (d, j), lexicographically: d fp32
    (not NaN; -0.0 counts as +0.0), 0 <= j < 2^31."""
    bits = (d + 0.0).view(torch.int32)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return mono * (1 << 32) + j


def _gallery_tiles(gf: torch.Tensor, g_chunk: int) -> list:
    """``gf`` as tiles of ``g_chunk`` rows, all of one shape: views of
    ``gf``, except a ragged last tile, which is a zero-padded copy made
    once (the gallery itself is never copied)."""
    tiles = list(gf.split(g_chunk))
    tail = tiles[-1]
    if tail.shape[0] < g_chunk:
        tiles[-1] = torch.cat([tail, tail.new_zeros(
            (g_chunk - tail.shape[0], gf.shape[1]))])
    return tiles


class _Shard(NamedTuple):
    """One block of gallery rows ``j0 .. j0 + len(tiles) * g_chunk`` on
    ``device``, with its rows' pids, camids and validity."""

    device: torch.device
    j0: int
    tiles: list
    g_pids: torch.Tensor
    g_cams: torch.Tensor
    g_valid: torch.Tensor


def _shards(gf, g_pids, g_camids, devices, g_chunk: int) -> list:
    """The gallery cut into ``len(devices)`` blocks of whole ``g_chunk``
    tiles, each placed on its device once: views where the rows are
    already there, a ragged tile's padded copy, zero tiles past the end."""
    num_g = gf.shape[0]
    width = shard_width(num_g, len(devices), g_chunk)
    pad_g = width * len(devices) - num_g

    def padded(x, fill):
        return torch.as_tensor(np.concatenate(
            [np.asarray(x, np.int64), np.full(pad_g, fill, np.int64)]))

    g_pids_p, g_cams_p = padded(g_pids, -1), padded(g_camids, -1)
    g_valid = torch.arange(num_g + pad_g) < num_g
    out = []
    for s, dev in enumerate(devices):
        lo = s * width
        rows = gf[lo:lo + width]
        tiles = _gallery_tiles(rows.to(dev), g_chunk) if len(rows) else []
        if len(tiles) < width // g_chunk:
            zero = gf.new_zeros((g_chunk, gf.shape[1]), device=dev)
            tiles += [zero] * (width // g_chunk - len(tiles))
        sl = slice(lo, lo + width)
        out.append(_Shard(dev, lo, tiles, g_pids_p[sl].to(dev),
                          g_cams_p[sl].to(dev), g_valid[sl].to(dev)))
    return out


def _extract(qf_c, pos_c, sh: _Shard, dist: str):
    """[Qc, H] fp32: each hit's distance read out of the score tile of
    ``sh`` it lives in, 0 for hits in other shards."""
    fn = get_dist_func(dist, eval_mode=True)
    c_rows = sh.tiles[0].shape[0]
    dpos = torch.zeros(pos_c.shape, dtype=torch.float32, device=sh.device)
    for c, tile in enumerate(sh.tiles):
        s = fn(qf_c, tile)                                  # [Qc, C] fp32
        local = pos_c - (sh.j0 + c * c_rows)
        inside = (local >= 0) & (local < c_rows)
        dpos = torch.where(inside, s.gather(1, local.clamp(0, c_rows - 1)),
                           dpos)
    return dpos


def _count(qf_c, qp_c, qc_c, pos_c, dpos, sh: _Shard, dist: str,
           respect_camids: bool):
    """[Qc, H] int32: the kept entries of ``sh`` ordered before each hit by
    (distance, index); ``dpos`` is the extraction over all shards."""
    fn = get_dist_func(dist, eval_mode=True)
    c_rows = sh.tiles[0].shape[0]
    cols = torch.arange(c_rows, device=sh.device)
    pos_key = _order_key(dpos, pos_c)
    ranks = torch.zeros(pos_c.shape, dtype=torch.int32, device=sh.device)
    for c, tile in enumerate(sh.tiles):
        s = fn(qf_c, tile)
        sl = slice(c * c_rows, (c + 1) * c_rows)
        match = sh.g_pids[None, sl] == qp_c[:, None]
        if respect_camids:
            same = ((sh.g_cams[None, sl] >> qc_c[:, None]) & 1) == 1
        else:
            same = sh.g_cams[None, sl] == qc_c[:, None]
        keep = ~(match & same) & sh.g_valid[None, sl]
        key = torch.where(keep,
                          _order_key(s, cols + (sh.j0 + c * c_rows)), _NEVER)
        for h0 in range(0, pos_c.shape[1], _H_CHUNK):
            before = key[:, None, :] < pos_key[:, h0:h0 + _H_CHUNK, None]
            ranks[:, h0:h0 + _H_CHUNK] += before.sum(dim=2,
                                                     dtype=torch.int32)
    return ranks


def _summed(parts: list, home: torch.device) -> torch.Tensor:
    out = parts[0].to(home)
    for p in parts[1:]:
        out = out + p.to(home)
    return out


def _stream_ranks(qf_c, qp_c, qc_c, pos_c, shards: list, dist: str,
                  respect_camids: bool):
    """The extract and count passes for one chunk of queries over the
    gallery ``shards``: (dpos [Qc, H] fp32, ranks [Qc, H] int32) on the
    first shard's device. Every shard's pass is enqueued before its
    results are gathered."""
    home = shards[0].device
    with annotate("eval.extract"):
        parts = []
        for sh in shards:
            with on_device(sh.device):
                parts.append(_extract(qf_c.to(sh.device),
                                      pos_c.to(sh.device), sh, dist))
        with on_device(home):
            dpos = _summed(parts, home)
    with annotate("eval.count"):
        parts = []
        for sh in shards:
            dev = sh.device
            with on_device(dev):
                parts.append(_count(qf_c.to(dev), qp_c.to(dev),
                                    qc_c.to(dev), pos_c.to(dev),
                                    dpos.to(dev), sh, dist, respect_camids))
        with on_device(home):
            return dpos, _summed(parts, home)


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
    ``eval.place``, ``eval.extract`` and ``eval.count`` (one each per query
    chunk) and ``eval.to_host``, and counts, from host values, the count
    pass's compares: ``eval.pairs_compared`` (padded query rows x H x
    padded gallery rows) and ``eval.pairs_useful`` (hits x G)."""
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
        shards = _shards(gf, g_pids, g_camids, devices, g_chunk)
        pos_d = torch.as_tensor(pos.astype(np.int64), device=dev)
        qp_d = torch.as_tensor(q_pids.astype(np.int64), device=dev)
        qc_d = torch.as_tensor(q_camids.astype(np.int64), device=dev)
    g_rows = sum(len(sh.tiles) for sh in shards) * g_chunk

    dpos_all, ranks_all = [], []
    for s in range(0, num_q, _Q_CHUNK):
        rows = min(_Q_CHUNK, num_q - s)
        pad_q = _Q_CHUNK - rows
        qf_c = torch.cat([qf[s:s + rows], qf.new_zeros((pad_q, qf.shape[1]))])
        qp_c = torch.cat([qp_d[s:s + rows], qp_d.new_full((pad_q,), -2)])
        qc_c = torch.cat([qc_d[s:s + rows], qc_d.new_zeros((pad_q,))])
        pos_c = torch.cat([pos_d[s:s + rows],
                           pos_d.new_full((pad_q, pos.shape[1]), -1)])
        count("eval.pairs_compared", _Q_CHUNK * pos.shape[1] * g_rows)
        count("eval.pairs_useful", int(num_rel[s:s + rows].sum()) * num_g)
        dpos, ranks = _stream_ranks(qf_c, qp_c, qc_c, pos_c, shards, dist,
                                    respect_camids)
        dpos_all.append(dpos[:rows])
        ranks_all.append(ranks[:rows])
    with annotate("eval.to_host"):
        dpos = torch.cat(dpos_all).cpu().numpy()
        ranks = torch.cat(ranks_all).cpu().numpy()
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
