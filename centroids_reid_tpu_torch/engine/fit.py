"""The training loop (counterpart of ``centroids_reid_tpu/engine/fit.py``,
one process on one device).

Per epoch: the LR of the schedule, the epoch's P x K identity plan, the
device-resident epoch (the image bank on the card, ``TPU.DEVICE_RESIDENT_DATA``
within ``TPU.DEVICE_DATA_BUDGET_MB``) or the host-streamed one, the epoch
metrics, the preemption stop, validation every ``SOLVER.EVAL_PERIOD``
epochs with the best-metric checkpoint, and the periodic ring checkpoint
every ``TPU.PERIODIC_CHECKPOINT_INTERVAL`` epochs. After the last epoch,
the double test with ``MODEL.USE_CENTROIDS`` toggled.

Augmentation draws come from a ``torch.Generator`` on the training device,
seeded from ``REPRODUCIBLE_SEED + 17 * seed`` and the epoch.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..data import TrainLoader, init_dataset
from ..data.device_data import bank_size_mb, build_image_bank, plan_to_arrays
from ..models import create_model
from ..models.convert import backbone_state_dict, load_torch_file
from ..solver import lr_for_epoch, set_learning_rate
from ..utils import PreemptionGuard, profile_trace
from .checkpoint import CheckpointManager, epoch_of_checkpoint, restore_state
from .epoch_runner import (
    make_augment,
    resident_batches,
    run_epoch,
    streamed_batches,
)
from .evaluate import run_validation
from .logging import MetricsLogger
from .state import TrainState, create_train_state
from .steps import make_train_step


def build_model_and_state(cfg, dataset, seed: int = 0,
                          device="cuda") -> TrainState:
    """The model (random init from ``seed``, then the pretrained backbone at
    ``MODEL.PRETRAIN_PATH`` when ``MODEL.PRETRAINED``, unless resuming or
    testing), channels_last on ``device``, with its centers and
    optimizers."""
    generator = torch.Generator().manual_seed(seed)
    model = create_model(cfg, num_classes=dataset.num_classes,
                         generator=generator)
    if (cfg.MODEL.PRETRAINED and cfg.MODEL.PRETRAIN_PATH
            and not cfg.MODEL.RESUME_TRAINING and not cfg.TEST.ONLY_TEST):
        print("Loading pretrained model......")
        sd = backbone_state_dict(load_torch_file(cfg.MODEL.PRETRAIN_PATH))
        # key by key, as the reference's load_param; a shape mismatch raises
        model.backbone.load_state_dict(sd, strict=False)
    model = model.to(device=device, memory_format=torch.channels_last)
    return create_train_state(cfg, model, dataset.num_classes, generator)


def _epoch_generator(base_seed: int, epoch: int, device) -> torch.Generator:
    seed = int(np.random.SeedSequence([base_seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _validate(cfg, model, dataset, use_centroids: bool) -> Dict[str, float]:
    """Validation in ``eval()`` mode; the model goes back to ``train()``."""
    model.eval()
    try:
        return run_validation(cfg, model, dataset, use_centroids=use_centroids)
    finally:
        model.train()


def fit(cfg, mode: str, log_dir: str, seed: int = 0, dataset=None,
        device="cuda") -> Dict[str, float]:
    """Train, validate, checkpoint, then the final double test. Returns the
    last validation's metrics and the double test's (``test_centroids_*``,
    ``test_plain_*``), or ``preempted`` when a SIGTERM stopped the run."""
    if cfg.DATALOADER.SAMPLER != "random_identity":
        raise NotImplementedError(
            f"Unknown sampler {cfg.DATALOADER.SAMPLER!r}; only "
            "'random_identity' exists")
    if dataset is None:
        dataset = init_dataset(cfg.DATASETS.NAMES, cfg)
        dataset.print_statistics()
    device = torch.device(device)

    state = build_model_and_state(cfg, dataset, seed, device)
    train_step = make_train_step(state, cfg, dataset.num_classes, mode)
    start_epoch = 0
    ckpt = CheckpointManager(log_dir, n_saved=1,
                             mode=cfg.SOLVER.MONITOR_METRIC_MODE)
    if cfg.MODEL.RESUME_TRAINING and cfg.MODEL.PRETRAIN_PATH:
        restore_state(cfg.MODEL.PRETRAIN_PATH, state)
        resumed = epoch_of_checkpoint(cfg.MODEL.PRETRAIN_PATH)
        start_epoch = (resumed + 1) if resumed is not None else 0
        print(f"Resumed from {cfg.MODEL.PRETRAIN_PATH} at epoch {start_epoch}")

    logger = MetricsLogger(log_dir, "train")
    logger.log_params({"mode": mode, "seed": seed, "config": cfg.dump()})
    loader = TrainLoader(dataset, cfg, prefetch=cfg.TPU.PREFETCH_DEPTH)
    augment = make_augment(cfg)
    base_seed = cfg.REPRODUCIBLE_SEED + 17 * seed
    size_hw = tuple(cfg.INPUT.SIZE_TRAIN)
    resident = (cfg.TPU.DEVICE_RESIDENT_DATA
                and bank_size_mb(dataset.train, size_hw)
                <= cfg.TPU.DEVICE_DATA_BUDGET_MB)
    bank = None
    if resident:
        print(f"Device-resident training data: "
              f"{bank_size_mb(dataset.train, size_hw):.0f} MB image bank")
        bank = torch.from_numpy(build_image_bank(
            dataset.train, size_hw, cfg.TPU.CACHE_IMAGES,
            cfg.DATALOADER.NUM_WORKERS)).to(device)

    metrics_out: Dict[str, float] = {}
    preempted = False
    state.model.train()
    with PreemptionGuard(enabled=cfg.TPU.GRACEFUL_PREEMPTION) as guard:
        for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCHS):
            lr = lr_for_epoch(epoch, cfg)
            set_learning_rate(state.optimizers, lr)
            generator = _epoch_generator(base_seed, epoch, device)
            t0 = time.time()
            with profile_trace(log_dir, enabled=cfg.TPU.PROFILE
                               and epoch == start_epoch):
                if resident:
                    idx, labels, is_real = (
                        torch.from_numpy(a[:, 0]).to(device)
                        for a in plan_to_arrays(loader.plan_for_epoch(epoch),
                                                dataset.train))
                    batches = resident_batches(bank, idx.long(),
                                               labels.long(), is_real)
                else:
                    batches = streamed_batches(loader.epoch(epoch), device)
                means, n_steps = run_epoch(train_step, batches, augment,
                                           generator)
                state.step += n_steps
                # one host sync for all the epoch's metrics
                names = list(means)
                values = (torch.stack([means[k] for k in names]).tolist()
                          if names else [])
            epoch_metrics = dict(zip(names, values))
            epoch_metrics["lr"] = lr
            epoch_metrics["epoch_time_s"] = time.time() - t0
            epoch_metrics["steps"] = n_steps
            epoch_metrics["epoch_train_loss"] = epoch_metrics.pop("loss", 0.0)
            if "step_dist_ap" in epoch_metrics:
                epoch_metrics["epoch_dist_ap"] = epoch_metrics.pop(
                    "step_dist_ap")
                epoch_metrics["epoch_dist_an"] = epoch_metrics.pop(
                    "step_dist_an")
            logger.log_metrics(epoch_metrics, step=epoch)
            print(f"epoch {epoch}: loss={epoch_metrics['epoch_train_loss']:.4f}"
                  f" lr={lr:.2e} steps={n_steps} "
                  f"({epoch_metrics['epoch_time_s']:.1f}s)")

            # the stop decision comes before the periodic validation: the
            # grace window is for the save
            if guard.should_stop():
                ckpt.save_periodic(epoch, state, cfg)
                preempted = True
                print(f"Preemption signal received — saved "
                      f"checkpoint_epoch{epoch}, stopping cleanly. Resume "
                      f"with MODEL.RESUME_TRAINING True MODEL.PRETRAIN_PATH "
                      f"<auto_checkpoints/checkpoint_epoch{epoch}>")
                break
            if (epoch + 1) % cfg.SOLVER.EVAL_PERIOD == 0:
                val = _validate(cfg, state.model, dataset,
                                cfg.MODEL.USE_CENTROIDS)
                logger.log_metrics(val, step=epoch)
                metrics_out = val
                ckpt.save_if_best(epoch, state,
                                  val[cfg.SOLVER.MONITOR_METRIC_NAME], cfg)
            if (epoch + 1) % cfg.TPU.PERIODIC_CHECKPOINT_INTERVAL == 0:
                ckpt.save_periodic(epoch, state, cfg)

    # the double test with both centroid modes; not after a preemption
    if preempted:
        metrics_out["preempted"] = 1.0
        final_modes = ()
    else:
        final_modes = (cfg.MODEL.USE_CENTROIDS, not cfg.MODEL.USE_CENTROIDS)
    for use_centroids in final_modes:
        val = _validate(cfg, state.model, dataset, use_centroids)
        tag = "centroids" if use_centroids else "plain"
        test = {f"test_{tag}_{k}": v for k, v in val.items()}
        logger.log_metrics(test, step=cfg.SOLVER.MAX_EPOCHS)
        metrics_out.update(test)
    logger.close()
    return metrics_out
