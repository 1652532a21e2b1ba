"""R1 / mAP evaluator: normalise, then rank and score (counterpart of
``centroids_reid_tpu/metrics/r1_map.py``).

On the materialising path the distance matrix (or, with ``rerank``, the
k-reciprocal re-ranked one of ``ops.rerank.rerank_distmat``) is computed on
the evaluator's device in gallery chunks of bounded size, ranked there with
a STABLE argsort (the reference's ``jnp.argsort`` is stable, and centroid
galleries tie), and scored there; only the metrics come back to the host.
Past ``_STREAMING_CELLS`` query x gallery cells, and with windowed
re-ranking, the streaming evaluator (``streaming_eval.py``) counts ranks
over score tiles instead and never builds the matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses.distances import get_dist_func
from ..utils.profiling import annotate
from .eval_reid import ReidMetrics, eval_func
from .streaming_eval import eval_func_streaming, eval_func_streaming_reranked

# Max fp32 elements of the distance matrix per gallery chunk (~256 MB).
_CHUNK_ELEMS = 64 * 1024 * 1024
# [Q, G] cells beyond which compute() switches to the streaming evaluator
# (the score matrix and its argsort would take Q * G * 12 bytes: 3 GB here)
_STREAMING_CELLS = 256 * 1024 * 1024


def compute_distmat_device(qf, gf, dist_name: str = "euclidean",
                           device="cuda") -> torch.Tensor:
    """[Q, D] x [G, D] -> [Q, G] fp32 distances as a tensor on ``device``
    (tensor inputs stay on their own device), computed in gallery chunks."""
    if not torch.is_tensor(qf):
        qf = torch.from_numpy(np.asarray(qf, np.float32)).to(device)
    if not torch.is_tensor(gf):
        gf = torch.from_numpy(np.asarray(gf, np.float32))
    qf, gf = qf.float(), gf.to(qf.device).float()
    q, g = qf.shape[0], gf.shape[0]
    fn = get_dist_func(dist_name, eval_mode=True)
    chunk = max(1, min(g, _CHUNK_ELEMS // max(q, 1)))
    parts = [fn(qf, gf[s:s + chunk]) for s in range(0, g, chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def compute_distmat(qf, gf, dist_name: str = "euclidean",
                    device="cuda") -> np.ndarray:
    """Host-output variant of ``compute_distmat_device``."""
    return compute_distmat_device(qf, gf, dist_name, device).cpu().numpy()


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    """torch F.normalize(p=2, dim=1) parity: x / max(||x||, eps)."""
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


class R1mAP:
    """Functional evaluator on one device (the card unless ``device`` says
    otherwise).

    ``streaming``: None (switch to the streaming evaluator past
    ``_STREAMING_CELLS``), or force True / False. Streaming gives the same
    metrics by counting ranks over score tiles and never builds the
    distance matrix, so ``last_distmat`` (rank visualisation) exists only
    after a materialising evaluation.

    ``rerank``: with ``rerank_window=0`` the distance matrix is replaced by
    the fully re-ranked one (``ops.rerank.rerank_distmat``, which refuses
    more than ``DEFAULT_MAX_N`` rows); it pins the materialising path, so
    ``rerank`` with ``streaming=True`` raises ``ValueError`` as in the
    reference (here when the evaluator is built). With ``rerank_window=r >
    0`` every evaluation is the windowed re-ranked one on the streaming
    evaluator (``eval_func_streaming_reranked``: each query's top-r window
    re-ranked, the tail in its original order), whatever the gallery size
    or ``streaming``.

    ``compute`` takes the features as an array or as a tensor; a tensor
    stays on its own device (a gallery on the card is never copied to the
    host). ``mesh`` (a ``parallel.Mesh``) shards the gallery rows of the
    streaming evaluations over its devices, plain and re-ranked, as the
    JAX package does; features go to its first device, which replaces
    ``device``. The materialising path ignores it."""

    def __init__(self, num_query: int, max_rank: int = 50,
                 feat_norm: bool = True, dist_name: str = "euclidean",
                 streaming: bool = None, mesh=None, rerank: bool = False,
                 rerank_k1: int = 20, rerank_k2: int = 6,
                 rerank_lambda: float = 0.3, rerank_window: int = 0,
                 device="cuda"):
        if rerank and streaming and not rerank_window:
            raise ValueError(
                "full re-ranking is O(N^2) and incompatible with the "
                "streaming evaluator; set TPU.RERANK_WINDOW > 0 (windowed "
                "re-ranking at any gallery scale), run with "
                "streaming=False (small/centroid galleries), or disable "
                "TPU.RERANK")
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.dist_name = dist_name
        self.streaming = streaming
        self.rerank = bool(rerank)
        self.rerank_k1 = rerank_k1
        self.rerank_k2 = rerank_k2
        self.rerank_lambda = rerank_lambda
        self.rerank_window = int(rerank_window)
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else torch.device(device))
        self._last_distmat_device = None

    def compute(self, feats, pids, camids,
                respect_camids: bool = False) -> ReidMetrics:
        """The metrics of one evaluation; under a running profiler, the
        span ``eval`` holds it on every path."""
        with annotate("eval"):
            return self._compute(feats, pids, camids, respect_camids)

    def _compute(self, feats, pids, camids,
                 respect_camids: bool) -> ReidMetrics:
        if not torch.is_tensor(feats):
            feats = torch.from_numpy(np.asarray(feats, np.float32))
        if feats.device.type == "cpu":
            feats = feats.to(self.device)
        feats = feats.float()
        if self.feat_norm:
            print("The test feature is normalized")
            feats = feats / feats.norm(dim=1, keepdim=True).clamp_min(1e-12)
        nq = self.num_query
        qf, gf = feats[:nq], feats[nq:]
        q_pids, g_pids = np.asarray(pids[:nq]), np.asarray(pids[nq:])
        q_camids, g_camids = np.asarray(camids[:nq]), np.asarray(camids[nq:])
        self._last_distmat_device = None

        if self.rerank and self.rerank_window > 0:
            # the window, not the gallery size, defines this metric
            return eval_func_streaming_reranked(
                qf, gf, q_pids, g_pids, q_camids, g_camids,
                r=self.rerank_window, k1=self.rerank_k1, k2=self.rerank_k2,
                lambda_value=self.rerank_lambda, max_rank=self.max_rank,
                respect_camids=respect_camids, dist=self.dist_name,
                mesh=self.mesh)
        stream = self.streaming
        if stream is None:
            stream = (not self.rerank
                      and qf.shape[0] * gf.shape[0] > _STREAMING_CELLS)
        if stream:
            return eval_func_streaming(
                qf, gf, q_pids, g_pids, q_camids, g_camids,
                max_rank=self.max_rank, respect_camids=respect_camids,
                dist=self.dist_name, mesh=self.mesh)

        if self.rerank:
            from ..ops.rerank import rerank_distmat

            distmat = rerank_distmat(
                qf, gf, k1=self.rerank_k1, k2=self.rerank_k2,
                lambda_value=self.rerank_lambda, dist=self.dist_name,
                device=self.device)
        else:
            distmat = compute_distmat_device(qf, gf, self.dist_name)
        indices = torch.argsort(distmat, dim=1, stable=True)
        metrics = eval_func(indices, q_pids, g_pids, q_camids, g_camids,
                            self.max_rank, respect_camids)
        self._last_distmat_device = distmat
        return metrics

    @property
    def last_distmat(self) -> np.ndarray:
        """Host copy of the last distance matrix."""
        if self._last_distmat_device is None:
            raise RuntimeError(
                "last_distmat is unavailable on the streaming evaluation "
                "path (the distance matrix is never materialised); run "
                "with streaming=False for rank visualisation")
        return self._last_distmat_device.cpu().numpy()
