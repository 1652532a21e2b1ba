"""The re-id model: backbone + GAP + BNNeck (+ bias-free classifier).

Counterpart of ``centroids_reid_tpu/models/baseline.py``. Module names are
the reference checkpoint's (``backbone.*``, ``bn.*``, ``fc_query.weight``),
so its state dicts load without renaming.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .dinov2 import is_dinov2, make_dinov2
from .resnet import backbone_emb_size, build_backbone, random_init_
from .swin import is_swin, make_swin
from .transreid import is_transformer, make_transreid


class ReidModel(nn.Module):
    """``num_classes = 0`` builds an inference-only model (no classifier).
    ``mixed_precision`` runs the trunk under bf16 autocast; ``embed``
    returns fp32 either way."""

    def __init__(self, backbone_name: str = "resnet50", last_stride: int = 1,
                 num_classes: int = 0, mixed_precision: bool = False):
        super().__init__()
        self.mixed_precision = mixed_precision
        self.backbone_name = backbone_name
        self.last_stride = last_stride
        self.backbone = build_backbone(backbone_name, last_stride)
        emb = backbone_emb_size(backbone_name)
        self.bn = nn.BatchNorm1d(emb, eps=1e-5)
        self.bn.bias.requires_grad_(False)  # the BNNeck bias is never trained
        self.fc_query = (nn.Linear(emb, num_classes, bias=False)
                         if num_classes > 0 else None)

    def features(self, x):
        """Global feature: spatial mean of the trunk output. x: NCHW."""
        return self.backbone(x).mean(dim=(2, 3))

    def embed(self, x, cams=None):
        """Eval-mode retrieval embedding bn(GAP(trunk(x))), fp32 [N, D].
        ``cams`` (camera ids) is taken and not read. Call on a model in
        ``eval()`` mode."""
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed_precision):
            e = self.bn(self.features(x))
        return e.float()


def init_model(model: ReidModel, generator: torch.Generator) -> ReidModel:
    """Reference random init of every layer, plus N(0, 0.001) for the
    classifier, drawn from ``generator`` (a CPU generator: initialise before
    moving the model to its device)."""
    random_init_(model, generator)
    if model.fc_query is not None:
        with torch.no_grad():
            model.fc_query.weight.normal_(0.0, 0.001, generator=generator)
    return model


def create_model(cfg, num_classes: int = 0,
                 generator: Optional[torch.Generator] = None,
                 cameras: int = 0):
    """The model ``MODEL.NAME`` names (a ``ReidModel``, or with
    ``transformer`` the one ``MODEL.TRANSFORMER_TYPE`` names: TransReID's
    ``TransReIDModel``, whose SIE needs the dataset's camera count
    ``cameras``, for a ``swin_*`` type SOLIDER-REID's ``SwinReID``, for a
    ``dinov2_*`` type DINOv2's ``DinoV2ReID``), initialised from
    ``generator`` (seed 0 when None), in eval mode on the CPU."""
    if is_transformer(cfg):
        if is_swin(cfg):
            model = make_swin(cfg, num_classes, generator)
        elif is_dinov2(cfg):
            model = make_dinov2(cfg, num_classes, generator)
        else:
            model = make_transreid(cfg, num_classes, cameras, generator)
        _check_emb_size(cfg, model.emb_size)
        return model
    _check_emb_size(cfg, backbone_emb_size(cfg.MODEL.NAME))
    # TPU.SPACE_TO_DEPTH_STEM only changes how the TPU computes the stem
    # conv, not the function or its parameters, so the port reads no flag
    model = ReidModel(cfg.MODEL.NAME, cfg.MODEL.LAST_STRIDE, num_classes,
                      mixed_precision=bool(cfg.USE_MIXED_PRECISION))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_model(model, generator).eval()


def _check_emb_size(cfg, emb: int) -> None:
    """The model's own embedding size wins over
    ``MODEL.BACKBONE_EMB_SIZE``, with a line saying so."""
    if emb != cfg.MODEL.BACKBONE_EMB_SIZE:
        print(
            f"[centroids_reid_tpu_torch] MODEL.BACKBONE_EMB_SIZE="
            f"{cfg.MODEL.BACKBONE_EMB_SIZE} != backbone native {emb}; "
            f"using {emb}"
        )
