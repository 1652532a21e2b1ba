"""Eval-time centroid construction, plain and camera-aware (counterpart of
``centroids_reid_tpu/metrics/centroids.py``).

* plain mode: one centroid per gallery pid, the mean of its gallery
  embeddings, in sorted-pid order; output = [query embeddings; centroids]
  with dummy camids (query 0, gallery 1);
* camera-aware mode (``MODEL.KEEP_CAMID_CENTROIDS``): for each pid and each
  camera id of that pid's queries (sorted, unique), a centroid of its
  gallery images from the OTHER cameras; identical used-camera combinations
  are built once. Gallery pids with no query produce no centroid. Query
  camids stay plain ids, centroid camids are int64 bitmasks of the cameras
  used.

Plain mode is a segment mean (``index_add_``) on the device of the
embeddings when they are a tensor; camera-aware mode is host combinatorics
over at most |pids| x |cams| groups with numpy means, as in the reference.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, NamedTuple

import numpy as np
import torch


class CentroidEvalSet(NamedTuple):
    embeddings: np.ndarray   # [num_query + num_centroids, D]
    labels: np.ndarray       # [num_query + num_centroids]
    camids: np.ndarray       # plain camids, or bitmasks when camera-aware
    respect_camids: bool


def build_plain_centroids(embeddings, labels: np.ndarray,
                          num_query: int) -> CentroidEvalSet:
    """Segment mean per gallery pid in fp32."""
    emb = (embeddings if torch.is_tensor(embeddings)
           else torch.from_numpy(np.asarray(embeddings, np.float32))).float()
    labels = np.asarray(labels)
    lab_q, lab_g = labels[:num_query], labels[num_query:]
    unique = np.sort(np.unique(lab_g))
    seg = torch.as_tensor(np.searchsorted(unique, lab_g), device=emb.device)
    emb_g = emb[num_query:]
    sums = emb_g.new_zeros((len(unique), emb.shape[1])).index_add_(0, seg,
                                                                  emb_g)
    cnts = emb_g.new_zeros(len(unique)).index_add_(
        0, seg, emb_g.new_ones(emb_g.shape[0]))
    centroids = sums / cnts.clamp_min(1.0)[:, None]
    out_emb = torch.cat([emb[:num_query], centroids]).cpu().numpy()
    out_lab = np.concatenate([lab_q, unique])
    camids = np.concatenate([np.zeros(num_query, np.int64),
                             np.ones(len(unique), np.int64)])
    return CentroidEvalSet(out_emb, out_lab, camids, False)


def build_camera_aware_centroids(embeddings, labels: np.ndarray,
                                 camids: np.ndarray,
                                 num_query: int) -> CentroidEvalSet:
    """Camera-aware construction with the camera-combination dedup."""
    embeddings = (embeddings.cpu().numpy() if torch.is_tensor(embeddings)
                  else np.asarray(embeddings))
    labels, camids = np.asarray(labels), np.asarray(camids)
    emb_q, lab_q, cam_q = (embeddings[:num_query], labels[:num_query],
                           camids[:num_query])
    emb_g, lab_g, cam_g = (embeddings[num_query:], labels[num_query:],
                           camids[num_query:])

    g_by_pid = defaultdict(list)
    for i, pid in enumerate(lab_g):
        g_by_pid[pid].append(i)
    q_by_pid = defaultdict(list)
    for i, pid in enumerate(lab_q):
        q_by_pid[pid].append(i)

    cent_emb: List[np.ndarray] = []
    cent_lab: List[int] = []
    cent_mask: List[int] = []
    for pid in sorted(np.unique(lab_g)):
        inds = np.asarray(g_by_pid[pid])
        cams_g = cam_g[inds]
        q_inds = q_by_pid.get(pid, [])
        seen_combos = set()
        for current in sorted(np.unique(cam_q[q_inds])) if q_inds else []:
            sel = np.nonzero(cams_g != current)[0]
            if sel.size == 0:
                continue
            used = tuple(sorted(np.unique(cams_g[sel])))
            if used in seen_combos:
                continue
            seen_combos.add(used)
            cent_emb.append(emb_g[inds[sel]].mean(axis=0))
            cent_lab.append(pid)
            mask = 0
            for c in used:
                mask |= 1 << int(c)
            cent_mask.append(mask)

    centroids = (np.stack(cent_emb) if cent_emb
                 else np.zeros((0, emb_g.shape[1])))
    out_emb = np.concatenate([emb_q, centroids], axis=0)
    out_lab = np.concatenate([lab_q, np.asarray(cent_lab, lab_q.dtype)])
    out_cam = np.concatenate([np.asarray(cam_q, np.int64),
                              np.asarray(cent_mask, np.int64)])
    return CentroidEvalSet(out_emb, out_lab, out_cam, True)


def build_centroid_eval_set(embeddings, labels, camids, num_query,
                            respect_camids: bool) -> CentroidEvalSet:
    if respect_camids:
        return build_camera_aware_centroids(embeddings, labels, camids,
                                            num_query)
    return build_plain_centroids(embeddings, labels, num_query)
