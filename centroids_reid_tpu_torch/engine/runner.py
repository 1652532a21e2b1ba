"""Top-level orchestration, test route (counterpart of
``centroids_reid_tpu/engine/runner.py``): log-directory allocation, the
``REPRODUCIBLE`` run loop and the ONLY_TEST path, which loads a reference
checkpoint and evaluates twice with ``MODEL.USE_CENTROIDS`` toggled.

    python -m centroids_reid_tpu_torch.engine.runner \\
        --config_file configs/256_resnet50.yml \\
        DATASETS.ROOT_DIR /data MODEL.PRETRAIN_PATH model.ckpt \\
        TEST.ONLY_TEST True

Runs on the card unless ``--device cpu``. Training (``TEST.ONLY_TEST
False``) is not ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from ..config import get_default_cfg
from ..data import init_dataset
from ..inference.api import load_inference_model
from .evaluate import run_validation
from .logging import MetricsLogger, next_version_dir


def load_model_for_test(cfg, device="cuda") -> torch.nn.Module:
    """The eval model with the weights of the reference ``.pth`` / ``.ckpt``
    file at ``MODEL.PRETRAIN_PATH``, on ``device``. An orbax checkpoint
    directory of the JAX package raises ``NotImplementedError``, as
    ``load_inference_model`` does."""
    if not cfg.MODEL.PRETRAIN_PATH:
        raise ValueError("TEST.ONLY_TEST requires MODEL.PRETRAIN_PATH")
    return load_inference_model(cfg, device)


def run_single(cfg, mode: str, logger_save_dir: str,
               device="cuda") -> Dict[str, float]:
    """One ONLY_TEST run: metrics with and without centroids, logged under
    ``LOG_DIR/<logger_save_dir>/version_N/test``."""
    if not cfg.TEST.ONLY_TEST:
        raise NotImplementedError(
            f"training ({mode}) is not ported yet; see ROADMAP.md queue 1 "
            "item 4. Set TEST.ONLY_TEST True to evaluate a checkpoint.")
    if cfg.TPU.RERANK:
        raise NotImplementedError(
            "TPU.RERANK is not ported yet; see ROADMAP.md queue 1 item 6")
    log_dir = next_version_dir(cfg.LOG_DIR, logger_save_dir)
    print(f"Logging to {log_dir}")
    with open(os.path.join(log_dir, "config.yml"), "w") as f:
        f.write(cfg.dump())

    dataset = init_dataset(cfg.DATASETS.NAMES, cfg)
    dataset.print_statistics()
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
    reference's run loop does (an evaluation draws no random numbers, so
    the runs' seeds do not matter here)."""
    cfg.LOG_DIR = (f"logs/{cfg.DATASETS.NAMES}" if cfg.OUTPUT_DIR == ""
                   else cfg.OUTPUT_DIR)
    out: Dict[str, float] = {}
    for _ in range(cfg.REPRODUCIBLE_NUM_RUNS):
        out = run_single(cfg, mode, logger_save_dir, device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """``train_ctl_model.py``'s flags (``--config_file`` plus ``KEY VALUE``
    opts) and ``--device``."""
    parser = argparse.ArgumentParser(description="CTL model evaluation")
    parser.add_argument("--config_file", default="", type=str,
                        help="path to config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options from the command line")
    args = parser.parse_args(argv)
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    return run_main(cfg, "ctl", "train_ctl_model", args.device)


if __name__ == "__main__":
    main()
