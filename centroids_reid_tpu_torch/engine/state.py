"""The train state (counterpart of ``centroids_reid_tpu/engine/state.py``):
the model, the center-loss centers, both optimizers and the step count."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..losses import init_centers
from ..solver import Optimizers, build_optimizers


@dataclass
class TrainState:
    model: torch.nn.Module         # ReidModel with a classifier
    centers: torch.nn.Parameter    # [C, D] center-loss centers
    optimizers: Optimizers
    step: int = 0                  # optimizer steps taken


def create_train_state(cfg, model, num_classes: int,
                       generator: torch.Generator) -> TrainState:
    """Centers drawn from ``generator`` (a CPU generator, as the model's
    init) on the model's device and in its dtype, and both optimizers. Move
    the model to its device first."""
    like = model.bn.weight
    centers = torch.nn.Parameter(init_centers(
        generator, num_classes, model.bn.num_features).to(like.device,
                                                          like.dtype))
    return TrainState(model, centers,
                      build_optimizers(model, centers, cfg))
