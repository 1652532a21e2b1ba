"""Validation / test: embedding extraction + centroid eval + metrics
(counterpart of the single-process half of
``centroids_reid_tpu/engine/evaluate.py``).

``emb = bn(GAP(trunk(x)))`` per batch on the model's device, concatenated
over query + gallery, optionally replaced by per-pid centroids, then R1 /
mAP on the same device. The reference's ``make_embed_many_fn`` scans
several batches in one dispatch to amortise its TPU's per-dispatch
latency; here each loader batch is one embed call (``make_embed_fn``).
Single process only: multi-process extraction and ``TEST.VISUALIZE`` are
not ported yet and raise ``NotImplementedError``. ``TPU.RERANK`` evaluates
on the fully re-ranked distance matrix; windowed re-ranked evaluation
(``TPU.RERANK_WINDOW > 0``) runs on the streaming evaluator in the
reference, is not ported yet, and ``validate_rerank_config`` refuses it at
startup.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..data.loader import EvalLoader, ImageStore
from ..metrics import K_LIST, R1mAP, build_centroid_eval_set


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _shared_store(dataset, cfg) -> ImageStore:
    """One decoded-image cache per dataset object: repeated validations
    (the ONLY_TEST double evaluation) skip re-decoding the val set."""
    size = tuple(cfg.INPUT.SIZE_TEST)
    store = getattr(dataset, "_eval_store", None)
    if store is None or store.size_hw != size:
        store = ImageStore(size, cfg.TPU.CACHE_IMAGES)
        dataset._eval_store = store
    return store


def make_embed_fn(model, cfg):
    """uint8 [B, H, W, 3] (array or tensor) -> fp32 [B, D] embeddings on
    the model's device: normalise, trunk under bf16 autocast when
    ``USE_MIXED_PRECISION``, GAP, BNNeck."""
    from ..inference.service import embed_query

    device = _model_device(model)
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    dtype = torch.bfloat16 if cfg.USE_MIXED_PRECISION else torch.float32

    @torch.inference_mode()
    def embed(imgs_u8):
        x = (imgs_u8 if torch.is_tensor(imgs_u8)
             else torch.from_numpy(np.ascontiguousarray(imgs_u8)))
        return embed_query(model, x.to(device), mean, std, dtype,
                           normalize=False)

    return embed


def _maybe_int8_eval_fn(cfg, model, records, store):
    """With ``TPU.INT8_EVAL`` in an ONLY_TEST run the embeddings come from
    the int8 serving path (``models.quantized.quantize_for_serving``), so
    the reported metrics measure the deployed quantized model."""
    if not (cfg.TPU.INT8_EVAL and cfg.TEST.ONLY_TEST):
        return None
    from ..models.quantized import quantize_for_serving

    qfn = quantize_for_serving(cfg, model, records, store=store)
    print("Evaluation uses the int8 serving path (TPU.INT8_EVAL)")
    return qfn


def extract_embeddings(model, cfg, loader: EvalLoader, embed_fn=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (embeddings [N, D] fp32, pids [N], camids [N]). One batch
    stays in flight: batch i + 1 is launched before batch i is copied to
    the host."""
    embed = embed_fn or make_embed_fn(model, cfg)
    embs, pids, camids = [], [], []
    pending = []
    for batch in loader:
        v = batch["valid"]
        pending.append((embed(batch["images"]), v))
        pids.append(batch["pids"][v])
        camids.append(batch["camids"][v])
        if len(pending) > 1:
            e, valid = pending.pop(0)
            embs.append(e.cpu().numpy()[valid])
    for e, valid in pending:
        embs.append(e.cpu().numpy()[valid])
    return (np.concatenate(embs).astype(np.float32, copy=False),
            np.concatenate(pids), np.concatenate(camids))


def _centroid_gallery_rows(g_pids, g_camids, q_pids, q_camids,
                           respect_camids: bool) -> int:
    """The number of gallery rows the centroid eval set will hold: the
    construction itself run on 1-wide zero embeddings (its row count
    depends only on the pids and camids)."""
    nq = len(np.asarray(q_pids))
    pids = np.concatenate([np.asarray(q_pids), np.asarray(g_pids)])
    camids = np.concatenate([np.asarray(q_camids), np.asarray(g_camids)])
    cent = build_centroid_eval_set(np.zeros((len(pids), 1), np.float32),
                                   pids, camids, num_query=nq,
                                   respect_camids=respect_camids)
    return int(len(cent.labels) - nq)


def validate_rerank_config(cfg, dataset) -> None:
    """Refuse at startup a ``TPU.RERANK`` run whose evaluation would fail
    later (at the first validation of a training run, hours in): full
    re-ranking of an eval set, with or without centroids, past
    ``ops.rerank.DEFAULT_MAX_N`` rows raises ``ValueError`` as in the
    reference; windowed re-ranked evaluation (``TPU.RERANK_WINDOW > 0``)
    needs the streaming evaluator, which is not ported yet
    (``NotImplementedError``)."""
    if not cfg.TPU.RERANK:
        return
    if int(cfg.TPU.RERANK_WINDOW) > 0:
        raise NotImplementedError(
            "TPU.RERANK with TPU.RERANK_WINDOW > 0 (windowed re-ranked "
            "evaluation) runs on the streaming evaluator, which is not "
            "ported yet; see ROADMAP.md queue 1 item 6 (the streaming "
            "evaluator, metrics/streaming_eval.py). Set TPU.RERANK_WINDOW 0 "
            "for full re-ranking.")
    from ..ops.rerank import DEFAULT_MAX_N

    nq = dataset.num_query
    val = dataset.val
    q_pids = np.asarray([r.pid for r in val[:nq]])
    q_camids = np.asarray([r.camid for r in val[:nq]])
    g_pids = np.asarray([r.pid for r in val[nq:]])
    g_camids = np.asarray([r.camid for r in val[nq:]])
    sizes = {"plain": nq + len(g_pids),
             "centroids": nq + _centroid_gallery_rows(
                 g_pids, g_camids, q_pids, q_camids,
                 bool(cfg.MODEL.KEEP_CAMID_CENTROIDS))}
    over = {m: n for m, n in sizes.items() if n > DEFAULT_MAX_N}
    if over:
        detail = ", ".join(f"{m} eval N={n}" for m, n in over.items())
        raise ValueError(
            f"TPU.RERANK (full k-reciprocal re-ranking) holds two [N, N] "
            f"fp32 matrices in HBM and refuses N > {DEFAULT_MAX_N}; this "
            f"run would evaluate {detail}. Set TPU.RERANK_WINDOW (e.g. "
            f"500) for windowed re-ranking at any gallery scale, or "
            f"disable TPU.RERANK.")


def compute_reid_metrics(cfg, embeddings, pids, camids, num_query: int,
                         use_centroids: bool, return_evaluator: bool = False,
                         device="cuda"):
    """Centroids (when ``use_centroids``) + R1 / mAP on ``device``; with
    ``TPU.RERANK``, on the k-reciprocal re-ranked distances."""
    respect = bool(cfg.MODEL.KEEP_CAMID_CENTROIDS and use_centroids)
    if use_centroids:
        print("Evaluation is done using centroids")
        es = build_centroid_eval_set(
            torch.from_numpy(np.asarray(embeddings, np.float32)).to(device),
            pids, camids, num_query, respect)
        embeddings, pids, camids = es.embeddings, es.labels, es.camids
    if cfg.TPU.RERANK:
        print("Re-ranking with k-reciprocal encoding (k1={}, k2={}, "
              "lambda={})".format(cfg.TPU.RERANK_K1, cfg.TPU.RERANK_K2,
                                  cfg.TPU.RERANK_LAMBDA))
    evaluator = R1mAP(num_query=num_query, feat_norm=cfg.TEST.FEAT_NORM,
                      dist_name=cfg.SOLVER.DISTANCE_FUNC,
                      rerank=bool(cfg.TPU.RERANK),
                      rerank_k1=int(cfg.TPU.RERANK_K1),
                      rerank_k2=int(cfg.TPU.RERANK_K2),
                      rerank_lambda=float(cfg.TPU.RERANK_LAMBDA),
                      rerank_window=int(cfg.TPU.RERANK_WINDOW), device=device)
    metrics = evaluator.compute(embeddings, pids, camids,
                                respect_camids=respect)
    if return_evaluator:
        return metrics, evaluator
    return metrics


def run_validation(cfg, model, dataset, use_centroids: bool
                   ) -> Dict[str, float]:
    """Full validation pass on the model's device; returns {'mAP': ...,
    'Top-1': ..., ...}."""
    if cfg.TEST.VISUALIZE == "yes":
        raise NotImplementedError(
            "TEST.VISUALIZE is not ported yet; see ROADMAP.md queue 1 item 6")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "multi-process extraction is not ported yet; see ROADMAP.md "
            "queue 1 item 6 (multi-GPU)")
    store = _shared_store(dataset, cfg)
    # one quantization per dataset object covers the double evaluation; the
    # key holds everything the quantized embed depends on
    int8_key = (
        bool(cfg.TPU.INT8_EVAL and cfg.TEST.ONLY_TEST),
        str(cfg.MODEL.PRETRAIN_PATH), str(cfg.TPU.INT8_CACHE_PATH),
        int(cfg.TPU.INT8_CALIB_BATCHES), float(cfg.TPU.INT8_CALIB_PCT),
        tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD),
    )
    int8_fn = None
    if getattr(dataset, "_int8_eval_key", None) == int8_key:
        int8_fn = getattr(dataset, "_int8_eval_fn", None)
    if int8_fn is None:
        int8_fn = _maybe_int8_eval_fn(cfg, model, dataset.val, store)
        if int8_fn is not None:
            dataset._int8_eval_fn = int8_fn
            dataset._int8_eval_key = int8_key
    emb, pids, camids = extract_embeddings(
        model, cfg, EvalLoader(dataset.val, cfg, store=store),
        embed_fn=int8_fn)
    m = compute_reid_metrics(cfg, emb, pids, camids, dataset.num_query,
                             use_centroids, device=_model_device(model))
    log = {"mAP": m.mAP}
    for val, kk in zip(m.all_topk, K_LIST):
        print("top-k, Rank-{:<3}:{:.1%}".format(kk, float(val)))
        log[f"Top-{kk}"] = float(val)
    print(f"mAP: {m.mAP}")
    return log
