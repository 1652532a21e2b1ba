"""The streaming evaluator's fp32 distance-and-rank kernel (Hopper), K7.

It replaces no TPU kernel: the JAX package's streaming evaluator
(``centroids_reid_tpu/metrics/streaming_eval.py``) is plain ``jnp``. One
hand-written CUDA kernel (``csrc/stream_rank.cu``) computes fp32 query x
gallery distances in registers, on the CUDA cores (no TF32), and ranks in
its epilogue, in two modes:

* ``stream_extract``: [Q, H] fp32, each query's hits' distances (the hits'
  gallery indices ``pos``, ascending, -1 padded) for the hits among the
  rows ``g``, 0 for the others;
* ``stream_count``: [Q, H] int32, a histogram. ``keys`` holds each query's
  hit keys ``order_key(distance, index)`` in ascending order (pads last).
  A kept row of ``g`` (not the query's pid and camera) whose key lies
  below the query's farthest hit adds one at p = the number of hit keys at
  or below its own key. So the inclusive prefix sum over p gives each
  sorted hit the number of kept rows ordered before it by (distance,
  index); a hit is never counted before itself.

Both modes compute each distance as one thread's chain of FFMAs over D in
order, so a (query, row) pair gets the same bits in both: a hit's distance
in the count is the one the extract wrote. The distance is euclidean
``(qn + gn) - 2 q.g`` from squared norms, as ``losses/distances.py``
computes it, or cosine ``|1 - (q.g qn) gn|`` clamped to 1e-12 from
inverse norms ``1 / max(|x|, 1e-12)``: the function of ``losses/
distances.py``'s cosine (rows normalised first) up to rounding. The norms
are made once per evaluation by ``prepare_rows``, a slice of rows at a
time, so no copy of the rows and no product as large as them exists.

The plain versions are the same rule in torch, over tiles of ``g_chunk``
gallery rows and ``_Q_CHUNK`` query rows: the count sorts nothing itself,
it takes each kept row's key under the farthest hit to ``torch.
searchsorted`` among the sorted hit keys and a bincount. Each wrapper runs
through a PyTorch operator (``torch.ops.crt.stream_extract``, ``torch.ops.
crt.stream_count``), so that a profiler's trace holds each call under its
name; the operator takes its plain version only for CPU tensors, and for
CUDA tensors launches its kernel or raises. Each launch adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .retrieval import _check, _on_cpu, _stream

_Q_CHUNK = 128            # the plain versions' query rows per score tile
_EPS = 1e-12              # losses/distances.py's cosine clamp
_DISTS = ("euclidean", "cosine")

LAUNCHES: Dict[str, int] = {"stream_extract": 0, "stream_count": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cosine(dist: str) -> bool:
    if dist not in _DISTS:
        raise ValueError(f"Unknown distance function {dist!r}")
    return dist == "cosine"


def prepare_rows(x: torch.Tensor, dist: str,
                 chunk: int = 8192) -> torch.Tensor:
    """[N] fp32, the norms both modes read with the rows ``x`` [N, D], made
    once per evaluation, ``chunk`` rows at a time: euclidean, the squared
    norms; cosine, the inverse norms ``1 / max(|x|, 1e-12)`` (the clamp of
    ``losses.distances.cosine_sim``)."""
    if _cosine(dist):
        n = torch.cat([t.norm(dim=-1) for t in x.split(chunk)])
        return n.clamp_min(_EPS).reciprocal()
    return torch.cat([(t * t).sum(dim=-1) for t in x.split(chunk)])


def order_key(d: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as the pairs (d, j), lexicographically: d fp32
    (not NaN; -0.0 counts as +0.0), 0 <= j < 2^31."""
    bits = (d + 0.0).view(torch.int32)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return mono * (1 << 32) + j


# ---------------------------------------------------------- plain ------

def _tiles(g, gn, g_chunk: int):
    """(offset, rows, norms) of each tile of ``g_chunk`` gallery rows."""
    for lo in range(0, g.shape[0], g_chunk):
        yield lo, g[lo:lo + g_chunk], gn[lo:lo + g_chunk]


def _distances(q, qn, t, tn, cosine: bool):
    """The score tile from ``prepare_rows``'s norms: euclidean ``(qn + tn)
    - 2 q.t``, cosine ``|1 - (q.t qn) tn|`` clamped."""
    s = q @ t.T
    if cosine:
        return (1.0 - s * qn[:, None] * tn[None, :]).abs().clamp_min(_EPS)
    return qn[:, None] + tn[None, :] - 2.0 * s


def _junk(q_pids, q_cams, g_pids, g_cams, respect_camids: bool):
    """[Qc, C]: same pid and same camera (camera bit set under
    ``respect_camids``)."""
    match = g_pids[None, :] == q_pids[:, None]
    if respect_camids:
        same = ((g_cams[None, :] >> q_cams[:, None]) & 1) == 1
    else:
        same = g_cams[None, :] == q_cams[:, None]
    return match & same


def stream_extract_plain(q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, pos,
                         num_rel, j0: int, dist: str, respect_camids: bool,
                         g_chunk: int):
    """[Q, H] fp32: each hit ``pos[q, h]`` among rows ``j0 ..`` of ``g``
    read out of its score tile, 0 for the other slots."""
    cosine = _cosine(dist)
    dpos = torch.zeros(pos.shape, dtype=torch.float32, device=pos.device)
    for s in range(0, q.shape[0], _Q_CHUNK):
        e = s + _Q_CHUNK
        for lo, t, tn in _tiles(g, gn, g_chunk):
            d = _distances(q[s:e], qn[s:e], t, tn, cosine)
            local = pos[s:e] - (j0 + lo)
            inside = (local >= 0) & (local < t.shape[0])
            got = d.gather(1, local.clamp(0, t.shape[0] - 1))
            dpos[s:e] = torch.where(inside, got, dpos[s:e])
    return dpos


def stream_count_plain(q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, keys,
                       num_rel, j0: int, dist: str, respect_camids: bool,
                       g_chunk: int):
    """[Q, H] int32: kept rows of ``g`` (global indices from ``j0``) under
    each query's farthest hit key, by the number of its sorted hit
    ``keys`` at or below their own key."""
    cosine = _cosine(dist)
    nq, h = keys.shape
    hist = torch.zeros((nq, h), dtype=torch.int64, device=keys.device)
    last = (num_rel.long() - 1).clamp_min(0)[:, None]
    far = torch.where(num_rel[:, None] > 0, keys.gather(1, last),
                      torch.iinfo(torch.int64).min)
    for s in range(0, nq, _Q_CHUNK):
        e = min(s + _Q_CHUNK, nq)
        keys_c = keys[s:e].contiguous()
        slot0 = torch.arange(e - s, device=keys.device)[:, None] * h
        for lo, t, tn in _tiles(g, gn, g_chunk):
            d = _distances(q[s:e], qn[s:e], t, tn, cosine)
            cols = torch.arange(lo, lo + t.shape[0], device=keys.device)
            key = order_key(d, cols + j0)
            searched = (key < far[s:e]) & ~_junk(
                q_pids[s:e], q_cams[s:e], g_pids[lo:lo + t.shape[0]],
                g_cams[lo:lo + t.shape[0]], respect_camids)
            p = torch.searchsorted(keys_c, key, right=True)
            hist[s:e] += torch.bincount(
                (slot0 + p)[searched], minlength=(e - s) * h).view(-1, h)
    return hist.to(torch.int32)


# --------------------------------------------------------- kernel ------

def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and on a 16-byte boundary (the kernel's cp.async)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(name: str, q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, hits,
            num_rel, out, j0: int, cosine: bool,
            respect_camids: bool) -> None:
    """Check the operands, then launch, check and count one K7 launch."""
    from . import _build

    if q.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"fp32 q and g required, got {q.dtype}, {g.dtype}")
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} x {tuple(g.shape)}")
    nq, ng = q.shape[0], g.shape[0]
    if hits.dtype != torch.int64 or hits.dim() != 2 \
            or hits.shape[0] != nq or hits.shape[1] < 1:
        raise ValueError(f"hits must be int64 [{nq}, H], got {hits.dtype} "
                         f"{tuple(hits.shape)}")
    ints = {"q_pids": (q_pids, nq), "q_cams": (q_cams, nq),
            "g_pids": (g_pids, ng), "g_cams": (g_cams, ng)}
    for what, (t, n) in ints.items():
        if t.dtype != torch.int64 or tuple(t.shape) != (n,):
            raise ValueError(f"{what} must be int64 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if num_rel.dtype != torch.int32 or tuple(num_rel.shape) != (nq,):
        raise ValueError(f"num_rel must be int32 [{nq}], got "
                         f"{num_rel.dtype} {tuple(num_rel.shape)}")
    if (tuple(qn.shape) != (nq,) or tuple(gn.shape) != (ng,)
            or qn.dtype != torch.float32 or gn.dtype != torch.float32):
        raise ValueError(f"norms must be fp32 qn [{nq}] and gn [{ng}], got "
                         f"{qn.dtype} {tuple(qn.shape)}, {gn.dtype} "
                         f"{tuple(gn.shape)}")
    if not (0 <= j0 and j0 + ng < 2 ** 31):
        raise ValueError(f"gallery indices {j0} .. {j0 + ng} out of int32")
    if nq == 0 or ng == 0:
        return
    pad = -q.shape[1] % 4
    if pad:                        # 16-byte chunks of D; zeros add nothing
        q, g = F.pad(q, (0, pad)), F.pad(g, (0, pad))
    q, g = _aligned(q), _aligned(g)
    ptrs = [t.contiguous() for t in (
        qn, gn, q_pids, g_pids, q_cams, g_cams, hits, num_rel)]
    rc = getattr(_build.load(), f"crt_{name}")(
        q.data_ptr(), g.data_ptr(), *[t.data_ptr() for t in ptrs],
        out.data_ptr(), nq, ng, q.shape[1], hits.shape[1], j0, int(cosine),
        int(respect_camids), _stream())
    _check(rc, name)
    LAUNCHES[name] += 1


def _extract_impl(q: torch.Tensor, qn: torch.Tensor,
                  g: torch.Tensor, gn: torch.Tensor,
                  q_pids: torch.Tensor, g_pids: torch.Tensor,
                  q_cams: torch.Tensor, g_cams: torch.Tensor,
                  pos: torch.Tensor, num_rel: torch.Tensor, j0: int,
                  dist: str, respect_camids: bool,
                  g_chunk: int) -> torch.Tensor:
    """The body of ``crt::stream_extract``: the plain version for CPU
    tensors, else the kernel."""
    args = (q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, pos, num_rel)
    if _on_cpu(*args):
        return stream_extract_plain(*args, j0, dist, respect_camids, g_chunk)
    out = torch.zeros(pos.shape, dtype=torch.float32, device=pos.device)
    _launch("stream_extract", *args, out, j0, _cosine(dist), respect_camids)
    return out


def _count_impl(q: torch.Tensor, qn: torch.Tensor,
                g: torch.Tensor, gn: torch.Tensor,
                q_pids: torch.Tensor, g_pids: torch.Tensor,
                q_cams: torch.Tensor, g_cams: torch.Tensor,
                keys: torch.Tensor, num_rel: torch.Tensor, j0: int,
                dist: str, respect_camids: bool,
                g_chunk: int) -> torch.Tensor:
    """The body of ``crt::stream_count``: the plain version for CPU
    tensors, else the kernel."""
    args = (q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, keys, num_rel)
    if _on_cpu(*args):
        return stream_count_plain(*args, j0, dist, respect_camids, g_chunk)
    out = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    _launch("stream_count", *args, out, j0, _cosine(dist), respect_camids)
    return out


# The operators are defined on a ``torch.library.Library`` and not with
# ``torch.library.custom_op``, which runs each kernel under
# ``torch._disable_dynamo``: its first call imports ``torch._dynamo`` (878
# modules, 9.6-9.8 s of host time on the card's machine), which every
# evaluating process would pay in its set-up. Nothing exports them, so
# they need no fake implementation.
_ARGS = ("Tensor q, Tensor qn, Tensor g, Tensor gn, Tensor q_pids, "
         "Tensor g_pids, Tensor q_cams, Tensor g_cams, Tensor {hits}, "
         "Tensor num_rel, int j0, str dist, bool respect_camids, "
         "int g_chunk")
_LIB = torch.library.Library("crt", "FRAGMENT")
for _name, _hits, _impl in (("stream_extract", "pos", _extract_impl),
                            ("stream_count", "keys", _count_impl)):
    _LIB.define(f"{_name}({_ARGS.format(hits=_hits)}) -> Tensor")
    _LIB.impl(_name, _impl, "CompositeExplicitAutograd")


def stream_extract(q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, pos,
                   num_rel, j0: int = 0, dist: str = "euclidean",
                   respect_camids: bool = False, g_chunk: int = 8192):
    """K7, extract mode: [Q, H] fp32 distances of the hits ``pos`` [Q, H]
    (int64, ascending, -1 padded; ``num_rel`` [Q] int32 of them) that lie
    among the rows ``j0 ..`` of ``g``, 0 elsewhere. ``qn``, ``gn``: the
    rows' norms from ``prepare_rows``; pids and cameras int64 (camera bitmasks
    under ``respect_camids``). ``g_chunk``: the plain version's tile."""
    return torch.ops.crt.stream_extract(
        q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, pos, num_rel, int(j0),
        str(dist), bool(respect_camids), int(g_chunk))


def stream_count(q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, keys,
                 num_rel, j0: int = 0, dist: str = "euclidean",
                 respect_camids: bool = False, g_chunk: int = 8192):
    """K7, count mode: [Q, H] int32 histogram of the kept rows of ``g``
    under each query's farthest hit, by how many of its sorted hit
    ``keys`` [Q, H] (int64, ascending, ``num_rel`` real) lie at or below
    their key. Other arguments as ``stream_extract``."""
    return torch.ops.crt.stream_count(
        q, qn, g, gn, q_pids, g_pids, q_cams, g_cams, keys, num_rel, int(j0),
        str(dist), bool(respect_camids), int(g_chunk))
