"""R1 / mAP evaluator: normalise, distance matrix, rank, score (counterpart
of ``centroids_reid_tpu/metrics/r1_map.py``, materialising path).

The distance matrix (or, with ``rerank``, the k-reciprocal re-ranked one
of ``ops.rerank.rerank_distmat``) is computed on the evaluator's device in
gallery chunks of bounded size, ranked there with a STABLE argsort (the
reference's ``jnp.argsort`` is stable, and centroid galleries tie), and
scored there; only the metrics come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses.distances import get_dist_func
from .eval_reid import ReidMetrics, eval_func

# Max fp32 elements of the distance matrix per gallery chunk (~256 MB).
_CHUNK_ELEMS = 64 * 1024 * 1024
# [Q, G] cells beyond which the reference switches to its streaming
# evaluator (metrics/streaming_eval.py), which is not ported yet
_STREAMING_CELLS = 256 * 1024 * 1024
_STREAMING_ITEM = ("ROADMAP.md queue 1 item 6 (the streaming evaluator, "
                   "metrics/streaming_eval.py)")


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
    otherwise). ``streaming``: None (materialise up to the reference's
    streaming threshold of 2^28 cells) or False.

    ``rerank``: with ``rerank_window=0`` the distance matrix is replaced by
    the fully re-ranked one (``ops.rerank.rerank_distmat``, which refuses
    more than ``DEFAULT_MAX_N`` rows); it pins the materialising path, so
    ``rerank`` with ``streaming=True`` raises ``ValueError`` as in the
    reference. Windowed re-ranked evaluation (``rerank_window > 0``) runs
    on the streaming evaluator in the reference; it, ``streaming=True`` and
    ``mesh`` are not ported yet and raise ``NotImplementedError``."""

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
        unported = {
            "windowed re-ranking (rerank with rerank_window > 0)":
                bool(rerank) and rerank_window > 0,
            "streaming": bool(streaming), "mesh": mesh is not None}
        for name, used in unported.items():
            if used:
                raise NotImplementedError(
                    f"R1mAP {name} is not ported yet; see {_STREAMING_ITEM}")
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.dist_name = dist_name
        self.rerank = bool(rerank)
        self.rerank_k1 = rerank_k1
        self.rerank_k2 = rerank_k2
        self.rerank_lambda = rerank_lambda
        self.device = torch.device(device)
        self._last_distmat_device = None

    def compute(self, feats, pids, camids,
                respect_camids: bool = False) -> ReidMetrics:
        feats = np.asarray(feats, np.float32)
        if self.feat_norm:
            print("The test feature is normalized")
            feats = l2_normalize_rows(feats)
        nq = self.num_query
        qf, gf = feats[:nq], feats[nq:]
        if self.rerank:
            from ..ops.rerank import rerank_distmat

            distmat = rerank_distmat(
                qf, gf, k1=self.rerank_k1, k2=self.rerank_k2,
                lambda_value=self.rerank_lambda, dist=self.dist_name,
                device=self.device)
        elif qf.shape[0] * gf.shape[0] > _STREAMING_CELLS:
            raise NotImplementedError(
                f"evaluating {qf.shape[0]} x {gf.shape[0]} cells needs the "
                f"streaming evaluator, which is not ported yet; see "
                f"{_STREAMING_ITEM}")
        else:
            distmat = compute_distmat_device(
                torch.from_numpy(qf).to(self.device), torch.from_numpy(gf),
                self.dist_name)
        indices = torch.argsort(distmat, dim=1, stable=True)
        metrics = eval_func(indices, np.asarray(pids[:nq]),
                            np.asarray(pids[nq:]), np.asarray(camids[:nq]),
                            np.asarray(camids[nq:]), self.max_rank,
                            respect_camids)
        self._last_distmat_device = distmat
        return metrics

    @property
    def last_distmat(self) -> np.ndarray:
        """Host copy of the last distance matrix."""
        if self._last_distmat_device is None:
            raise RuntimeError("no distance matrix computed yet")
        return self._last_distmat_device.cpu().numpy()
