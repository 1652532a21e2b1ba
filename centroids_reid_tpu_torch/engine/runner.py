"""Top-level orchestration (counterpart of
``centroids_reid_tpu/engine/runner.py``): log-directory allocation, the
``REPRODUCIBLE`` run loop, the training route (``fit``: train, validate,
checkpoint, then the double test) and the ONLY_TEST route, which loads a
checkpoint (a reference ``.pth`` / ``.ckpt`` file, a checkpoint directory
that ``fit`` wrote, or an orbax checkpoint of the JAX package) and evaluates
twice with ``MODEL.USE_CENTROIDS`` toggled. ``run_single`` applies
``TPU.MATMUL_PRECISION`` to the whole run, as the reference does. The CLI
of both root scripts, ``train_ctl_model.py`` (``--mode ctl``, the default)
and ``train_base_model.py`` (``--mode base``):

    python -m centroids_reid_tpu_torch.engine.runner \\
        --config_file configs/256_resnet50.yml \\
        DATASETS.ROOT_DIR /data MODEL.PRETRAIN_PATH resnet50.pth

    python -m centroids_reid_tpu_torch.engine.runner \\
        --config_file configs/256_resnet50.yml \\
        DATASETS.ROOT_DIR /data MODEL.PRETRAIN_PATH model.ckpt \\
        TEST.ONLY_TEST True

Runs on the card unless ``--device cpu``. Under ``torchrun`` (its
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) the run joins a process group, NCCL on the cards (one
process per card, ``cuda:LOCAL_RANK``) and gloo with ``--device cpu``,
and trains data-parallel, one group per process with ``TPU.NUM_GROUPS
0``:

    torchrun --standalone --nproc_per_node 8 \\
        -m centroids_reid_tpu_torch.engine.runner \\
        --config_file configs/256_resnet50.yml TPU.NUM_GROUPS 0 ...
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import get_default_cfg
from ..data import init_dataset
from ..inference.api import load_inference_model
from ..parallel.mesh import (
    barrier,
    distributed,
    process_count,
    process_device,
    process_index,
)
from ..utils import seed_everything
from .evaluate import run_validation, validate_rerank_config
from .fit import fit
from .logging import MetricsLogger, latest_version_dir, next_version_dir

# the process group's collective timeout: long enough for the skew of a
# process decoding its image bank or a rank-0 checkpoint write
DIST_TIMEOUT = datetime.timedelta(minutes=30)


def load_model_for_test(cfg, device="cuda") -> torch.nn.Module:
    """The eval model with the weights at ``MODEL.PRETRAIN_PATH`` (a
    reference ``.pth`` / ``.ckpt`` file, a checkpoint directory of ``fit``
    or an orbax checkpoint of the JAX package), on ``device``."""
    if not cfg.MODEL.PRETRAIN_PATH:
        raise ValueError("TEST.ONLY_TEST requires MODEL.PRETRAIN_PATH")
    return load_inference_model(cfg, device)


# TPU.MATMUL_PRECISION -> whether fp32 matmuls and convolutions may use
# TF32 (None: leave the switches as they are)
_TF32 = {"default": None, "highest": False, "float32": False,
         "tensorfloat32": True}


@contextlib.contextmanager
def matmul_precision(value: str):
    """``TPU.MATMUL_PRECISION`` for the enclosed work, the switches restored
    afterwards: ``default`` leaves them; ``highest`` and ``float32`` turn
    TF32 off for cuBLAS matmuls and cuDNN convolutions (exact fp32),
    ``tensorfloat32`` turns it on. JAX's other values (``high`` is bf16_3x,
    ``bfloat16`` one bf16 pass) have no cuBLAS / cuDNN setting that
    computes the same thing and raise ``ValueError``."""
    if value not in _TF32:
        raise ValueError(
            f"TPU.MATMUL_PRECISION {value!r} cannot be honoured on CUDA for "
            f"training or evaluation; the port honours "
            f"{', '.join(sorted(_TF32))}")
    tf32 = _TF32[value]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        if tf32 is not None:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            torch.set_float32_matmul_precision("high" if tf32 else "highest")
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL for a CUDA ``device`` (this process's card is
    ``cuda:LOCAL_RANK``), gloo for the CPU, with ``DIST_TIMEOUT``. Then a
    barrier, the counterpart of the JAX package's ``_warm_collectives``:
    the first NCCL collective builds the communicator, and it should do so
    while the processes are in step, not behind one still decoding its
    image bank. Returns whether it initialised a group; without
    ``WORLD_SIZE``, or in a group already, it does nothing. A failed
    initialisation raises: the run never falls back to one process."""
    if "WORLD_SIZE" not in os.environ or distributed():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, timeout=DIST_TIMEOUT)
    barrier()
    if process_index() == 0:
        print(f"torch.distributed initialised: {process_count()} processes "
              f"({backend})")
    return True


def allocate_version_dir(base: str, name: str) -> str:
    """``<base>/<name>/version_N`` for this run: process 0 allocates the
    next one, then a barrier, then every other process takes the newest;
    in one process, the next one."""
    if process_count() == 1:
        return next_version_dir(base, name)
    if process_index() == 0:
        path = next_version_dir(base, name)
        barrier()
        return path
    barrier()
    return latest_version_dir(base, name)


def run_single(cfg, mode: str, logger_save_dir: str,
               device="cuda") -> Dict[str, float]:
    """One run under ``LOG_DIR/<logger_save_dir>/version_N``: ``fit`` in
    ``mode`` ('ctl' or 'base'), or with ``TEST.ONLY_TEST`` the metrics with
    and without centroids, logged under ``test``; under
    ``TPU.MATMUL_PRECISION`` (``matmul_precision``)."""
    with matmul_precision(cfg.TPU.MATMUL_PRECISION):
        return _run_single(cfg, mode, logger_save_dir, device)


def _run_single(cfg, mode: str, logger_save_dir: str,
                device) -> Dict[str, float]:
    is_main = process_index() == 0
    log_dir = allocate_version_dir(cfg.LOG_DIR, logger_save_dir)
    if is_main:
        print(f"Logging to {log_dir}")
        with open(os.path.join(log_dir, "config.yml"), "w") as f:
            f.write(cfg.dump())

    dataset = init_dataset(cfg.DATASETS.NAMES, cfg)
    if is_main:
        dataset.print_statistics()
    # refuse a re-ranking config whose evaluation would fail mid-run
    validate_rerank_config(cfg, dataset)
    if not cfg.TEST.ONLY_TEST:
        return fit(cfg, mode, log_dir, seed=cfg.REPRODUCIBLE_SEED,
                   dataset=dataset, device=device)
    model = load_model_for_test(cfg, device)
    logger = MetricsLogger(log_dir, "test", enabled=is_main)
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
    seed from ``REPRODUCIBLE_SEED`` on. A preempted run ends the loop.
    Under ``torchrun`` the runs join its process group
    (``maybe_initialize_distributed``), left at the end."""
    initialized = maybe_initialize_distributed(device)
    try:
        device = process_device(device)
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
    finally:
        if initialized:
            dist.destroy_process_group()


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
