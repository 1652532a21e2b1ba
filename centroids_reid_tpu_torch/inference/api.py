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
from ..models import create_model
from ..models.convert import full_state_dict, load_torch_file

log = logging.getLogger(__name__)


def load_inference_model(cfg, device="cuda") -> torch.nn.Module:
    """The inference model (no classifier) with the weights at
    ``MODEL.PRETRAIN_PATH``, in eval mode on ``device`` (the card unless the
    caller asks for the CPU): a reference ``.pth`` / ``.ckpt`` file, or a
    checkpoint directory that the port's ``fit`` wrote (``state.pt``).
    Keys a reference file lacks keep their seed-0 init, as the reference
    ``load_param`` copies key by key. Channels-last memory format, which
    cuDNN's convolutions prefer."""
    path = cfg.MODEL.PRETRAIN_PATH
    if not path:
        raise ValueError("MODEL.PRETRAIN_PATH must point to a checkpoint")
    model = create_model(cfg, num_classes=0)
    if os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            raise NotImplementedError(
                f"{path} holds no {STATE_FILE}: if it is an orbax checkpoint "
                "of the JAX package, loading one is not ported yet, see "
                "ROADMAP.md queue 1 item 7 (orbax checkpoints). Use a "
                "checkpoint directory of the port's fit or a reference "
                ".pth/.ckpt file.")
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

    Routing as in the reference: ``ops.retrieval.topk_retrieval`` (exact
    fp32, hierarchical top-k on K3) when ``TPU.USE_PALLAS_RETRIEVAL`` and
    ``topk`` > 0, else the full distance matrix and a stable argsort (the
    reference's host ``np.argsort`` is not stable: equal distances may
    order differently there). ``TPU.RERANK`` and ``TPU.SHARDED_RETRIEVAL``
    are not ported yet and raise ``NotImplementedError``."""
    from ..metrics.r1_map import compute_distmat_device, l2_normalize_rows
    from ..ops.retrieval import topk_retrieval

    for flag, item in (("RERANK", "re-ranking"),
                       ("SHARDED_RETRIEVAL", "multi-GPU")):
        if getattr(cfg.TPU, flag):
            raise NotImplementedError(
                f"TPU.{flag} is not ported yet; see ROADMAP.md queue 1 "
                f"item 6 ({item})")
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
    if use_pallas and topk:
        dists, indices = topk_retrieval(
            torch.from_numpy(np.asarray(embeddings, np.float32)).to(device),
            torch.from_numpy(np.asarray(embeddings_gallery, np.float32)
                             ).to(device), topk, dist=dist)
    else:
        distmat = compute_distmat_device(embeddings, embeddings_gallery, dist,
                                         device)
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
