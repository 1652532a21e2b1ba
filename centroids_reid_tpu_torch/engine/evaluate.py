"""Validation / test: embedding extraction + centroid eval + metrics
(counterpart of ``centroids_reid_tpu/engine/evaluate.py``).

``emb = bn(GAP(trunk(x)))`` per batch on the model's device, concatenated
over query + gallery, optionally replaced by per-pid centroids, then R1 /
mAP on the same device (the streaming evaluator past 2^28 query x gallery
cells). The reference's ``make_embed_many_fn`` scans several batches in
one dispatch to amortise its TPU's per-dispatch latency; here each loader
batch is one embed call (``make_embed_fn``). ``TPU.RERANK`` evaluates on
the fully re-ranked distance matrix, or with ``TPU.RERANK_WINDOW > 0`` on
each query's re-ranked window (streaming, any gallery size).
``TEST.VISUALIZE yes`` writes one rank strip per query under
``OUTPUT_DIR/visrank``. In a process group of more than one process
(``fit``'s validation, the double test and ONLY_TEST under ``torchrun``)
each process embeds a contiguous slice of the val set and the slices are
gathered in record order (``extract_embeddings_sharded``): every process
ranks the same full set and computes the same metrics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..data.loader import EvalLoader, ImageStore
from ..metrics import K_LIST, R1mAP, build_centroid_eval_set
from ..parallel.mesh import process_allgather, process_count, process_index


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


def make_embed_fn(model, cfg, input_format: str = "rgb"):
    """uint8 batches (array or tensor) -> [B, D] embeddings on the model's
    device: normalise, trunk under bf16 autocast when
    ``USE_MIXED_PRECISION``, GAP, BNNeck. ``input_format="rgb"`` takes
    [B, H, W, 3] and returns fp32; ``"yuv420"`` (``TPU.FAST_DECODE``) takes
    packed planar YUV420 [B, 1.5 * H * W] of ``INPUT.SIZE_TEST``, unpacks
    it on the device, and returns bf16 (half the bytes back to the host;
    ``extract_embeddings`` widens them to fp32), as the reference."""
    from ..inference.service import embed_query

    device = _model_device(model)
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    dtype = torch.bfloat16 if cfg.USE_MIXED_PRECISION else torch.float32
    size_hw = tuple(cfg.INPUT.SIZE_TEST)

    @torch.inference_mode()
    def embed(imgs_u8):
        x = (imgs_u8 if torch.is_tensor(imgs_u8)
             else torch.from_numpy(np.ascontiguousarray(imgs_u8)))
        e = embed_query(model, x.to(device), mean, std, dtype,
                        normalize=False, size_hw=size_hw)
        return e.to(torch.bfloat16) if input_format == "yuv420" else e

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
    the host (in the embed's dtype, widened to fp32 there)."""
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
            embs.append(e.cpu().float().numpy()[valid])
    for e, valid in pending:
        embs.append(e.cpu().float().numpy()[valid])
    return (np.concatenate(embs).astype(np.float32, copy=False),
            np.concatenate(pids), np.concatenate(camids))


def balanced_slice(n: int, n_proc: int, rank: int) -> Tuple[int, int]:
    """Contiguous balanced [lo, hi) split of n rows over n_proc ranks:
    sizes differ by at most one and every rank is non-empty when
    n >= n_proc."""
    return rank * n // n_proc, (rank + 1) * n // n_proc


def extract_embeddings_sharded(model, cfg, records, store, embed_fn=None
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``extract_embeddings`` over the processes of the group: each embeds
    its balanced contiguous slice of ``records`` (``balanced_slice``; at
    least one record each when there are as many records as processes),
    and the slices are gathered in rank order, which is record order
    (``process_allgather`` pads them to the longest and cuts the padding
    off). Every process returns the full (embeddings, pids, camids),
    having decoded and embedded only its slice."""
    lo, hi = balanced_slice(len(records), process_count(), process_index())
    emb, pids, camids = extract_embeddings(
        model, cfg, EvalLoader(records[lo:hi], cfg, store=store),
        embed_fn=embed_fn)
    ids = np.stack([pids, camids], axis=1)      # int64, as the loader's
    g_emb = process_allgather(torch.from_numpy(emb)).numpy()
    g_ids = process_allgather(torch.from_numpy(ids)).numpy()
    return g_emb, g_ids[:, 0], g_ids[:, 1]


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
    later (at the first validation of a training run, hours in), with the
    reference's ``ValueError``s: full re-ranking of an eval set, with or
    without centroids, past ``ops.rerank.DEFAULT_MAX_N`` rows; windowed
    re-ranking (``TPU.RERANK_WINDOW > 0``, any gallery size) together with
    ``TEST.VISUALIZE yes``, which needs the distance matrix that the
    windowed evaluation never builds."""
    if not cfg.TPU.RERANK:
        return
    if int(cfg.TPU.RERANK_WINDOW) > 0:
        if cfg.TEST.VISUALIZE == "yes":
            raise ValueError(
                "TEST.VISUALIZE needs the materialised distance matrix, "
                "but windowed re-ranking (TPU.RERANK_WINDOW > 0) "
                "evaluates on the streaming path — drop one of the two "
                "settings")
        return
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
                         streaming: bool = None, device="cuda"):
    """Centroids (when ``use_centroids``) + R1 / mAP on ``device``; with
    ``TPU.RERANK``, on the k-reciprocal re-ranked distances (each query's
    window with ``TPU.RERANK_WINDOW > 0``). ``streaming`` goes to
    ``R1mAP``: None switches to the streaming evaluator past its cell
    count; a caller that reads ``evaluator.last_distmat`` afterwards (rank
    visualisation) passes False. Full re-ranking pins the materialising
    path."""
    respect = bool(cfg.MODEL.KEEP_CAMID_CENTROIDS and use_centroids)
    if use_centroids:
        print("Evaluation is done using centroids")
        es = build_centroid_eval_set(
            torch.from_numpy(np.asarray(embeddings, np.float32)).to(device),
            pids, camids, num_query, respect)
        embeddings, pids, camids = es.embeddings, es.labels, es.camids
    if cfg.TPU.RERANK and cfg.TPU.RERANK_WINDOW > 0:
        print("Windowed re-ranking with k-reciprocal encoding (r={}, "
              "k1={}, k2={}, lambda={})".format(
                  cfg.TPU.RERANK_WINDOW, cfg.TPU.RERANK_K1,
                  cfg.TPU.RERANK_K2, cfg.TPU.RERANK_LAMBDA))
    elif cfg.TPU.RERANK:
        print("Re-ranking with k-reciprocal encoding (k1={}, k2={}, "
              "lambda={})".format(cfg.TPU.RERANK_K1, cfg.TPU.RERANK_K2,
                                  cfg.TPU.RERANK_LAMBDA))
        streaming = False
    evaluator = R1mAP(num_query=num_query, feat_norm=cfg.TEST.FEAT_NORM,
                      dist_name=cfg.SOLVER.DISTANCE_FUNC,
                      streaming=streaming, rerank=bool(cfg.TPU.RERANK),
                      rerank_k1=int(cfg.TPU.RERANK_K1),
                      rerank_k2=int(cfg.TPU.RERANK_K2),
                      rerank_lambda=float(cfg.TPU.RERANK_LAMBDA),
                      rerank_window=int(cfg.TPU.RERANK_WINDOW), device=device)
    metrics = evaluator.compute(embeddings, pids, camids,
                                respect_camids=respect)
    if return_evaluator:
        return metrics, evaluator
    return metrics


def evaluate_on_train(cfg, model, dataset, use_centroids: bool = True
                      ) -> Dict[str, float]:
    """Train-set retrieval diagnostic ("Train mAP"), on the model's device
    and in its ``eval()`` mode (its mode is restored after). The
    reference's ``eval_on_train`` (modelling/bases.py:320-357) is dead
    code; this is the JAX package's working form: every train image
    queries the train set (as images, or per-pid centroids with
    ``use_centroids``), with the usual same pid and camid removal."""
    training = model.training
    model.eval()
    try:
        emb, pids, camids = extract_embeddings(
            model, cfg, EvalLoader(dataset.train, cfg,
                                   store=_shared_store(dataset, cfg)))
    finally:
        model.train(training)
    m = compute_reid_metrics(
        cfg, np.concatenate([emb, emb]), np.concatenate([pids, pids]),
        np.concatenate([camids, camids]), len(emb), use_centroids,
        device=_model_device(model))
    log = {"Train mAP": m.mAP}
    for val, kk in zip(m.all_topk, K_LIST):
        print("Train top-k, Rank-{:<3}:{:.1%}".format(kk, float(val)))
        log[f"Train Top-{kk}"] = float(val)
    print(f"Train mAP: {m.mAP}")
    return log


def run_validation(cfg, model, dataset, use_centroids: bool
                   ) -> Dict[str, float]:
    """Full validation pass on the model's device; returns {'mAP': ...,
    'Top-1': ..., ...}. With ``TEST.VISUALIZE yes`` the evaluation stays on
    the materialising path and writes the rank strips under
    ``OUTPUT_DIR/visrank`` (rank 0's). With more than one process and at
    least as many val records, the extraction is sharded
    (``extract_embeddings_sharded``)."""
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
    n_proc = process_count()
    if n_proc > 1 and len(dataset.val) >= n_proc:
        emb, pids, camids = extract_embeddings_sharded(
            model, cfg, dataset.val, store, embed_fn=int8_fn)
    else:
        emb, pids, camids = extract_embeddings(
            model, cfg, EvalLoader(dataset.val, cfg, store=store),
            embed_fn=int8_fn)
    visualize = cfg.TEST.VISUALIZE == "yes"
    m, evaluator = compute_reid_metrics(
        cfg, emb, pids, camids, dataset.num_query, use_centroids,
        return_evaluator=True, streaming=False if visualize else None,
        device=_model_device(model))
    if visualize and process_index() == 0:
        import os

        from ..metrics.visrank import visualize_ranked_results

        print("Start visualization...")
        visualize_ranked_results(
            evaluator.last_distmat, dataset.query, dataset.gallery,
            save_dir=os.path.join(cfg.OUTPUT_DIR or ".", "visrank"),
            width=cfg.INPUT.SIZE_TEST[1], height=cfg.INPUT.SIZE_TEST[0],
            topk=cfg.TEST.VISUALIZE_TOPK, use_centroids=use_centroids,
            respect_camids=bool(cfg.MODEL.KEEP_CAMID_CENTROIDS
                                and use_centroids),
            max_number=cfg.TEST.VISUALIZE_MAX_NUMBER)
    log = {"mAP": m.mAP}
    for val, kk in zip(m.all_topk, K_LIST):
        print("top-k, Rank-{:<3}:{:.1%}".format(kk, float(val)))
        log[f"Top-{kk}"] = float(val)
    print(f"mAP: {m.mAP}")
    return log
