"""Top-level orchestration (counterpart of
``centroids_reid_tpu/engine/runner.py``): log-directory allocation, the
``REPRODUCIBLE`` run loop, the training route (``fit``: train, validate,
checkpoint, then the double test) and the ONLY_TEST route, which loads a
checkpoint (a reference ``.pth`` / ``.ckpt`` file or a checkpoint directory
that ``fit`` wrote) and evaluates twice with ``MODEL.USE_CENTROIDS``
toggled. The CLI of both root scripts, ``train_ctl_model.py`` (``--mode
ctl``, the default) and ``train_base_model.py`` (``--mode base``):

    python -m centroids_reid_tpu_torch.engine.runner \\
        --config_file configs/256_resnet50.yml \\
        DATASETS.ROOT_DIR /data MODEL.PRETRAIN_PATH resnet50.pth

    python -m centroids_reid_tpu_torch.engine.runner \\
        --config_file configs/256_resnet50.yml \\
        DATASETS.ROOT_DIR /data MODEL.PRETRAIN_PATH model.ckpt \\
        TEST.ONLY_TEST True

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from ..config import get_default_cfg
from ..data import init_dataset
from ..inference.api import load_inference_model
from ..utils import seed_everything
from .evaluate import run_validation
from .fit import fit
from .logging import MetricsLogger, next_version_dir


def load_model_for_test(cfg, device="cuda") -> torch.nn.Module:
    """The eval model with the weights at ``MODEL.PRETRAIN_PATH`` (a
    reference ``.pth`` / ``.ckpt`` file or a checkpoint directory of
    ``fit``), on ``device``. An orbax checkpoint directory of the JAX
    package raises ``NotImplementedError``, as ``load_inference_model``
    does."""
    if not cfg.MODEL.PRETRAIN_PATH:
        raise ValueError("TEST.ONLY_TEST requires MODEL.PRETRAIN_PATH")
    return load_inference_model(cfg, device)


def run_single(cfg, mode: str, logger_save_dir: str,
               device="cuda") -> Dict[str, float]:
    """One run under ``LOG_DIR/<logger_save_dir>/version_N``: ``fit`` in
    ``mode`` ('ctl' or 'base'), or with ``TEST.ONLY_TEST`` the metrics with
    and without centroids, logged under ``test``."""
    if cfg.TPU.RERANK:
        raise NotImplementedError(
            "TPU.RERANK is not ported yet; see ROADMAP.md queue 1 item 6")
    log_dir = next_version_dir(cfg.LOG_DIR, logger_save_dir)
    print(f"Logging to {log_dir}")
    with open(os.path.join(log_dir, "config.yml"), "w") as f:
        f.write(cfg.dump())

    dataset = init_dataset(cfg.DATASETS.NAMES, cfg)
    dataset.print_statistics()
    if not cfg.TEST.ONLY_TEST:
        return fit(cfg, mode, log_dir, seed=cfg.REPRODUCIBLE_SEED,
                   dataset=dataset, device=device)
    model = load_model_for_test(cfg, device)
    logger = MetricsLogger(log_dir, "test")
    out: Dict[str, float] = {}
    for use_centroids in (cfg.MODEL.USE_CENTROIDS,
                          not cfg.MODEL.USE_CENTROIDS):
        val = run_validation(cfg, model, dataset, use_centroids=use_centroids)
        tag = "centroids" if use_centroids else "plain"
        logger.log_metrics({f"test_{tag}_{k}": v for k, v in val.items()},
                           step=0)
        out.update({f"test_{tag}_{k}": v for k, v in val.items()})
    logger.close()
    return out


def run_main(cfg, mode: str, logger_save_dir: str,
             device="cuda") -> Dict[str, float]:
    """Multi-run entry: ``LOG_DIR`` from ``OUTPUT_DIR`` (or
    ``logs/<dataset>``), then ``REPRODUCIBLE_NUM_RUNS`` runs, as the
    reference's run loop does; with ``REPRODUCIBLE`` each run takes the next
    seed from ``REPRODUCIBLE_SEED`` on. A preempted run ends the loop."""
    cfg.LOG_DIR = (f"logs/{cfg.DATASETS.NAMES}" if cfg.OUTPUT_DIR == ""
                   else cfg.OUTPUT_DIR)
    out: Dict[str, float] = {}
    base = cfg.REPRODUCIBLE_SEED
    for run in range(cfg.REPRODUCIBLE_NUM_RUNS):
        if cfg.REPRODUCIBLE:
            cfg.REPRODUCIBLE_SEED = base + run
            seed_everything(cfg.REPRODUCIBLE_SEED)
        out = run_single(cfg, mode, logger_save_dir, device)
        if out.get("preempted"):
            break
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """The root training scripts' flags (``--config_file`` plus ``KEY
    VALUE`` opts), ``--mode`` (``ctl``: ``train_ctl_model.py``, ``base``:
    ``train_base_model.py``) and ``--device``."""
    parser = argparse.ArgumentParser(
        description="CTL / baseline model training and evaluation")
    parser.add_argument("--config_file", default="", type=str,
                        help="path to config file")
    parser.add_argument("--mode", default="ctl", choices=("ctl", "base"),
                        help="ctl: centroid triplet loss (train_ctl_model); "
                             "base: the baseline (train_base_model)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options from the command line")
    args = parser.parse_args(argv)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    return run_main(cfg, args.mode, f"train_{args.mode}_model", args.device)


if __name__ == "__main__":
    main()
