"""Optimizers and the epoch LR schedule (counterpart of
``centroids_reid_tpu/solver/build.py``).

Two ``torch.optim`` optimizers, as the reference has:

* ``Adam(BASE_LR, weight_decay=WEIGHT_DECAY)``, betas (0.9, 0.999), eps
  1e-8, over every model parameter that trains (the BNNeck bias does not).
  Its weight decay is coupled L2 (``wd * p`` added to the gradient before
  the moments), which is the JAX package's ``add_decayed_weights`` ->
  ``scale_by_adam`` chain;
* ``SGD(CENTER_LR)`` over the center-loss centers, after their gradient is
  scaled by ``1 / CENTER_LOSS_WEIGHT``.

The LR is a function of the epoch (the reference's scheduler steps once per
epoch): ``lr_for_epoch`` computes it and ``set_learning_rate`` writes it
into Adam's param groups between epochs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_for_epoch(epoch: int, hparams) -> float:
    """BASE_LR times the multistep or cosine decay; during warmup
    ``BASE_LR * (epoch + 1) / WARMUP_EPOCHS`` instead."""
    s = hparams.SOLVER
    lr = s.BASE_LR
    if s.LR_SCHEDULER_NAME == "multistep_lr":
        lr *= s.GAMMA ** sum(1 for m in s.LR_STEPS if epoch >= m)
    elif s.LR_SCHEDULER_NAME == "cosine_annealing":
        eta_min = s.MIN_LR
        lr = eta_min + (s.BASE_LR - eta_min) * (
            1 + math.cos(math.pi * epoch / s.MAX_EPOCHS)) / 2
    else:
        raise NotImplementedError(f"No such scheduler {s.LR_SCHEDULER_NAME}")
    if s.USE_WARMUP_LR and epoch < s.WARMUP_EPOCHS:
        lr = s.BASE_LR * min(1.0, float(epoch + 1) / float(s.WARMUP_EPOCHS))
    return lr


class Optimizers:
    """Adam over the model and SGD over the centers, stepped together."""

    def __init__(self, model: torch.optim.Adam, centers: torch.optim.SGD,
                 center_grad_scale: float):
        self.model = model
        self.centers = centers
        self.center_grad_scale = center_grad_scale

    def zero_grad(self) -> None:
        self.model.zero_grad(set_to_none=True)
        self.centers.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Scale the centers' gradient by ``1 / CENTER_LOSS_WEIGHT``, then
        step both optimizers."""
        for group in self.centers.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(self.center_grad_scale)
        self.model.step()
        self.centers.step()

    def state_dict(self) -> Dict[str, dict]:
        return {"model": self.model.state_dict(),
                "centers": self.centers.state_dict()}

    def load_state_dict(self, sd: Dict[str, dict]) -> None:
        self.model.load_state_dict(sd["model"])
        self.centers.load_state_dict(sd["centers"])


def build_optimizers(model: torch.nn.Module, centers: torch.nn.Parameter,
                     hparams) -> Optimizers:
    s = hparams.SOLVER
    if s.OPTIMIZER_NAME != "Adam":
        raise NotImplementedError(f"No such optimizer {s.OPTIMIZER_NAME}")
    params = [p for p in model.parameters() if p.requires_grad]
    adam = torch.optim.Adam(params, lr=s.BASE_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=s.WEIGHT_DECAY)
    sgd = torch.optim.SGD([centers], lr=s.CENTER_LR)
    return Optimizers(adam, sgd, 1.0 / s.CENTER_LOSS_WEIGHT)


def set_learning_rate(optimizers: Optimizers, lr: float) -> None:
    """Write the epoch's LR into Adam's param groups."""
    for group in optimizers.model.param_groups:
        group["lr"] = lr


def current_learning_rate(optimizers: Optimizers) -> float:
    """The model optimizer's LR."""
    return float(optimizers.model.param_groups[0]["lr"])

