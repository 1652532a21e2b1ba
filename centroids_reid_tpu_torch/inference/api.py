"""Loading a model for inference (counterpart of
``centroids_reid_tpu/inference/api.py::load_inference_model``)."""

from __future__ import annotations

import os

import torch

from ..models import create_model
from ..models.convert import full_state_dict, load_torch_file


def load_inference_model(cfg, device) -> torch.nn.Module:
    """The inference model (no classifier) with the weights of the
    reference ``.pth`` / ``.ckpt`` file at ``MODEL.PRETRAIN_PATH``, in eval
    mode on ``device``. Keys the file lacks keep their seed-0 init, as the
    reference ``load_param`` copies key by key. Channels-last memory format,
    which cuDNN's convolutions prefer."""
    path = cfg.MODEL.PRETRAIN_PATH
    if not path:
        raise ValueError("MODEL.PRETRAIN_PATH must point to a checkpoint")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package); loading it is not ported yet, see ROADMAP.md queue 1 "
            "(checkpointing). Use a reference .pth/.ckpt file."
        )
    model = create_model(cfg, num_classes=0)
    sd = full_state_dict(load_torch_file(path))
    sd.pop("fc_query.weight", None)
    model.load_state_dict(sd, strict=False)  # still raises on a shape mismatch
    return model.to(device=device, memory_format=torch.channels_last).eval()
