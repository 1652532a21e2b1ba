"""The offline-inference API of the CLIs (counterpart of
``centroids_reid_tpu/inference/api.py``): ``load_inference_model``,
``build_embeddings`` (the gallery index of ``create_embeddings``) and
``find_similar`` (the top-k retrieval of ``get_similar``, with the
reference's ``.npy`` outputs). Everything runs on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..engine.checkpoint import STATE_FILE, load_state_file
from ..engine.orbax_read import is_orbax_checkpoint, read_checkpoint
from ..models import create_model
from ..models.convert import (
    from_jax_params,
    full_state_dict,
    load_converted,
    load_torch_file,
)
from ..models.transreid import (
    checkpoint_cameras,
    family,
    is_transformer,
    load_transreid_state_dict,
    refuse,
)

log = logging.getLogger(__name__)


def load_inference_model(cfg, device="cuda") -> torch.nn.Module:
    """The inference model (no classifier) with the weights at
    ``MODEL.PRETRAIN_PATH``, in eval mode on ``device`` (the card unless the
    caller asks for the CPU): a reference ``.pth`` / ``.ckpt`` file, a
    checkpoint directory that the port's ``fit`` wrote (``state.pt``), or an
    orbax checkpoint of the JAX package (its ``params.model`` but
    ``fc_query``, and ``batch_stats``; the optimizer state is not decoded).
    Keys a reference file lacks keep their seed-0 init, as the reference
    ``load_param`` copies key by key. Channels-last memory format, which
    cuDNN's convolutions prefer. A transformer (``MODEL.NAME
    transformer``: TransReID, or SOLIDER-REID's Swin) loads its own
    ``.pth`` by its names, with TransReID's SIE sized by the file."""
    path = cfg.MODEL.PRETRAIN_PATH
    if not path:
        raise ValueError("MODEL.PRETRAIN_PATH must point to a checkpoint")
    if is_transformer(cfg):
        if os.path.isdir(path):
            refuse("a checkpoint directory", "fit trains no transformer and "
                   "the JAX package has none; give the checkpoint's .pth "
                   "file", family(cfg))
        sd = load_torch_file(path)
        model = create_model(cfg, num_classes=0,
                             cameras=checkpoint_cameras(sd))
        load_transreid_state_dict(model, sd)
        return model.to(device=device,
                        memory_format=torch.channels_last).eval()
    model = create_model(cfg, num_classes=0)
    if is_orbax_checkpoint(path):
        tree = read_checkpoint(path, subtrees=[("params", "model"),
                                               ("batch_stats",)])
        params = {k: v for k, v in tree["params"]["model"].items()
                  if k != "fc_query"}
        load_converted(model, from_jax_params(params, tree["batch_stats"]))
    elif os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(
                f"{path} is neither a checkpoint directory of the port's fit "
                f"({STATE_FILE}) nor a committed orbax checkpoint of the JAX "
                f"package (_METADATA and an OCDBT manifest; an unfinished "
                f"save, *.orbax-checkpoint-tmp-*, is none)")
        sd = dict(load_state_file(path)["model"])
        sd.pop("fc_query.weight", None)
        model.load_state_dict(sd)
    else:
        sd = full_state_dict(load_torch_file(path))
        sd.pop("fc_query.weight", None)
        model.load_state_dict(sd, strict=False)  # raises on a shape mismatch
    return model.to(device=device, memory_format=torch.channels_last).eval()


def _image_store(cfg):
    """One decoded-image store per CLI run, shared between the int8
    calibration pass and the embedding loop."""
    from ..data.loader import ImageStore
    from .utils import serving_ingest_format

    return ImageStore(tuple(cfg.INPUT.SIZE_TEST), cfg.TPU.CACHE_IMAGES,
                      fmt=serving_ingest_format(cfg))


def maybe_int8_embed_fn(cfg, model, paths, store=None):
    """With ``TPU.INT8_EVAL``: the int8 serving embed through the shared
    cfg-driven flow (``models.quantized.quantize_for_serving``: cache load
    and check, or calibration on the leading input batches). None when
    the flag is off. Pass the ``store`` the embedding loop uses, so the
    calibration images are decoded once."""
    if not cfg.TPU.INT8_EVAL:
        return None
    from ..data.datasets import Record
    from ..models.quantized import quantize_for_serving

    records = [Record(p, 0, 0, i) for i, p in enumerate(paths)]
    return quantize_for_serving(cfg, model, records, store=store)


def _embed_folder(cfg, images_in_subfolders: bool, print_freq: int,
                  device):
    from .utils import list_images_flat, list_images_subfolders, run_inference

    lister = (list_images_subfolders if images_in_subfolders
              else list_images_flat)
    paths = lister(cfg.DATASETS.ROOT_DIR)
    if not paths:
        raise RuntimeError("Length of dataloader = 0")
    model = load_inference_model(cfg, device)
    log.info("Running inference")
    store = _image_store(cfg)
    return run_inference(
        model, cfg, paths, print_freq,
        embed_fn=maybe_int8_embed_fn(cfg, model, paths, store=store),
        store=store)


def build_embeddings(cfg, images_in_subfolders: bool, print_freq: int = 10,
                     pid_from: str = "parent_dir", device="cuda"):
    """The create_embeddings flow: embeds ``DATASETS.ROOT_DIR`` and saves
    ``embeddings.npy`` + ``paths.npy`` under ``OUTPUT_DIR`` (per-pid
    centroids and pid strings with ``MODEL.USE_CENTROIDS``)."""
    from .utils import PID_EXTRACTORS, calculate_centroids, create_pid_path_index

    embeddings, paths = _embed_folder(cfg, images_in_subfolders, print_freq,
                                      device)
    if cfg.MODEL.USE_CENTROIDS:
        log.info("Creating centroids")
        index = create_pid_path_index(paths, PID_EXTRACTORS[pid_from])
        embeddings, paths = calculate_centroids(embeddings, index)
    save_dir = Path(cfg.OUTPUT_DIR)
    save_dir.mkdir(exist_ok=True, parents=True)
    log.info(f"Saving embeddings and index to {save_dir}")
    np.save(save_dir / "embeddings.npy", embeddings)
    np.save(save_dir / "paths.npy", paths)
    return embeddings, paths


def find_similar(cfg, gallery_data: str, images_in_subfolders: bool,
                 normalize_features: bool, topk: int, print_freq: int = 10,
                 use_pallas: Optional[bool] = None, device="cuda"):
    """The get_similar flow: embeds ``DATASETS.ROOT_DIR`` as queries, ranks
    the index under ``gallery_data`` and saves ``results.npy`` (query path
    -> {indices, paths, distances}), ``query_embeddings.npy`` and
    ``query_paths.npy`` under ``OUTPUT_DIR``.

    Routing as in the reference:

    * ``TPU.RERANK`` with ``topk`` > 0 and ``TPU.RERANK_WINDOW`` > 0:
      windowed re-ranking (``ops.rerank.rerank_topk``) of each query's
      top-``max(TPU.RERANK_WINDOW, topk)`` window, the first ``topk`` kept;
    * ``TPU.RERANK`` otherwise: the fully re-ranked distance matrix
      (``ops.rerank.rerank_distmat``, at most ``DEFAULT_MAX_N`` rows in
      all) and a stable argsort;
    * ``TPU.SHARDED_RETRIEVAL`` with ``topk`` > 0: ``parallel.retrieval.
      sharded_topk`` over a mesh of every visible card (of the CPU for
      ``device="cpu"``), with a warning when fewer than two are visible
      (the mesh then has one device); at ``topk`` 0 a warning, and the
      routes below;
    * ``ops.retrieval.topk_retrieval`` (exact fp32, hierarchical top-k on
      K3) when ``TPU.USE_PALLAS_RETRIEVAL`` and ``topk`` > 0;
    * else the full distance matrix and a stable argsort (the reference's
      host ``np.argsort`` is not stable: equal distances may order
      differently there).

    The re-rankers' local distance is ``SOLVER.DISTANCE_FUNC``.
    ``TPU.RERANK`` is routed before ``TPU.SHARDED_RETRIEVAL``, as in the
    reference."""
    from ..metrics.r1_map import compute_distmat_device, l2_normalize_rows
    from ..ops.rerank import rerank_distmat, rerank_topk
    from ..ops.retrieval import topk_retrieval
    from ..parallel import mesh as pmesh
    from ..parallel.retrieval import sharded_topk

    embeddings, paths = _embed_folder(cfg, images_in_subfolders, print_freq,
                                      device)
    load_path = Path(gallery_data)
    embeddings_gallery = np.load(load_path / "embeddings.npy",
                                 allow_pickle=True)
    paths_gallery = np.load(load_path / "paths.npy", allow_pickle=True)
    if normalize_features:
        embeddings_gallery = l2_normalize_rows(embeddings_gallery)
        embeddings = l2_normalize_rows(embeddings)

    log.info("Calculating distance and getting the most similar ids per query")
    if use_pallas is None:
        use_pallas = cfg.TPU.USE_PALLAS_RETRIEVAL
    dist = cfg.SOLVER.DISTANCE_FUNC
    tpu = cfg.TPU
    rerank_kw = dict(k1=int(tpu.RERANK_K1), k2=int(tpu.RERANK_K2),
                     lambda_value=float(tpu.RERANK_LAMBDA), dist=dist,
                     device=device)
    sharded = tpu.SHARDED_RETRIEVAL and not tpu.RERANK
    if sharded and not topk:
        # --topk 0 ranks every gallery entry: the full [Q, G] matrix
        log.warning(
            "TPU.SHARDED_RETRIEVAL requires --topk > 0 (ranking ALL gallery "
            "entries materialises the full distance matrix on one device); "
            "proceeding with the materialising path")
    if tpu.RERANK and topk and tpu.RERANK_WINDOW > 0:
        r = max(int(tpu.RERANK_WINDOW), topk)
        log.info("Windowed re-ranking with k-reciprocal encoding (r=%d, "
                 "k1=%d, k2=%d, lambda=%.2f)", r, tpu.RERANK_K1,
                 tpu.RERANK_K2, tpu.RERANK_LAMBDA)
        dists, indices = rerank_topk(embeddings, embeddings_gallery, r=r,
                                     **rerank_kw)
        dists = dists[:, :topk].cpu().numpy()
        indices = indices[:, :topk].cpu().numpy()
    elif sharded and topk:
        devices = pmesh.local_devices(device)
        if len(devices) < 2:
            log.warning("TPU.SHARDED_RETRIEVAL needs >= 2 devices; using one")
        dists, indices = sharded_topk(
            embeddings, embeddings_gallery, topk,
            pmesh.make_retrieval_mesh(devices=devices), dist=dist)
    elif use_pallas and topk and not tpu.RERANK:
        dists, indices = topk_retrieval(
            torch.from_numpy(np.asarray(embeddings, np.float32)).to(device),
            torch.from_numpy(np.asarray(embeddings_gallery, np.float32)
                             ).to(device), topk, dist=dist)
    else:
        if tpu.RERANK:
            log.info("Re-ranking with k-reciprocal encoding (k1=%d, k2=%d, "
                     "lambda=%.2f)", tpu.RERANK_K1, tpu.RERANK_K2,
                     tpu.RERANK_LAMBDA)
            distmat = rerank_distmat(embeddings, embeddings_gallery,
                                     **rerank_kw)
        else:
            distmat = compute_distmat_device(embeddings, embeddings_gallery,
                                             dist, device)
        order = torch.argsort(distmat, dim=1, stable=True)
        if topk:
            order = order[:, :topk]
        dists = torch.gather(distmat, 1, order).cpu().numpy()
        indices = order.cpu().numpy()
    out = {qp: {"indices": indices[i], "paths": paths_gallery[indices[i]],
                "distances": dists[i]}
           for i, qp in enumerate(paths)}
    save_dir = Path(cfg.OUTPUT_DIR)
    save_dir.mkdir(exist_ok=True, parents=True)
    log.info(f"Saving results to {save_dir}")
    np.save(save_dir / "results.npy", out)
    np.save(save_dir / "query_embeddings.npy", embeddings)
    np.save(save_dir / "query_paths.npy", paths)
    return out
