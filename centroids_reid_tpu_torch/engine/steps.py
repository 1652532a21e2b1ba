"""The training step of the CTL and baseline models (counterpart of
``centroids_reid_tpu/engine/steps.py``).

One step: the trunk forward under bf16 autocast (``USE_MIXED_PRECISION``)
on a channels_last batch, the features cast to the parameters' dtype
(fp32), the masked BNNeck, ``fc_query``, the four weighted losses,
backward, the Adam step and the center SGD step.

* BNNeck: its batch statistics come from the real rows only (ctl; all rows
  in base), so it is not ``nn.BatchNorm1d`` in train mode, which would let
  the mock rows in. ``masked_bnneck`` computes it differentiably, the
  gradient flowing through the batch mean and variance as in the JAX
  package, with ``BatchNorm1d``'s conventions: biased variance to
  normalise, unbiased for the running variance, momentum 0.1.
* Trunk BN: ``nn.BatchNorm2d`` in train mode, which updates the running
  variance with the unbiased batch variance, as the original PyTorch
  reference does. The JAX package's Flax ``BatchNorm`` uses the biased one:
  the two running variances differ by n / (n - 1) per layer, n = rows x H x
  W (ROADMAP.md queue 3).
* One group: ``TPU.NUM_GROUPS`` > 1 raises ``NotImplementedError``. A trunk
  forward over G * P * K rows would mix the groups' BN statistics, which
  the JAX step's ``vmap`` keeps apart; at G = 1 the two agree.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..losses import (
    center_loss,
    cross_entropy_label_smooth,
    ctl_centroid_loss,
    triplet_loss,
)
from ..utils import annotate

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * running + m * batch


def masked_bnneck(feat, is_real, weight, bias, running_mean, running_var
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm1d in training mode over the rows of ``is_real``.

    feat [N, D] -> (bn_out [N, D], (new running mean, new running var)), in
    the dtype of ``feat`` and the weights; the new statistics carry no
    gradient."""
    m = is_real[:, None]
    cnt = is_real.sum().clamp_min(1).to(feat.dtype)
    mean = torch.where(m, feat, 0.0).sum(dim=0) / cnt
    centered = feat - mean
    var = torch.where(m, centered * centered, 0.0).sum(dim=0) / cnt
    out = centered * torch.rsqrt(var + _BN_EPS) * weight + bias
    with torch.no_grad():
        unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
        new_mean = (1 - _BN_MOMENTUM) * running_mean + _BN_MOMENTUM * mean
        new_var = (1 - _BN_MOMENTUM) * running_var + _BN_MOMENTUM * unbiased
    return out, (new_mean, new_var)


def make_loss_fn(model, centers, cfg, num_classes: int, mode: str
                 ) -> Callable:
    """``loss_fn(images, labels, is_real) -> (total, metrics, bnneck
    stats)``: the step's forward, on a model in ``train()`` mode. images
    [P*K, H, W, 3] (augmented, normalised), labels [P*K], is_real [P*K]."""
    if mode not in ("ctl", "base"):
        raise ValueError(f"mode must be 'ctl' or 'base', not {mode!r}")
    if cfg.TPU.NUM_GROUPS > 1:
        raise NotImplementedError(
            f"training with TPU.NUM_GROUPS={cfg.TPU.NUM_GROUPS} groups is not "
            "ported yet; see ROADMAP.md queue 1 item 6 (multi-GPU)")
    s = cfg.SOLVER
    k = cfg.DATALOADER.NUM_INSTANCE
    margin, dist = s.MARGIN, s.DISTANCE_FUNC
    w_xent = s.QUERY_XENT_WEIGHT
    w_query = s.QUERY_CONTRASTIVE_WEIGHT
    w_centroid = s.CENTROID_CONTRASTIVE_WEIGHT
    w_center = s.CENTER_LOSS_WEIGHT

    def loss_fn(images, labels, is_real):
        x = images.permute(0, 3, 1, 2)   # NHWC -> a channels_last NCHW view
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=model.mixed_precision):
            feat = model.features(x)
        feat = feat.to(model.bn.weight.dtype)   # bf16 -> fp32 under autocast
        bn_mask = is_real if mode == "ctl" else torch.ones_like(is_real)
        bn_out, stats = masked_bnneck(feat, bn_mask, model.bn.weight,
                                      model.bn.bias, model.bn.running_mean,
                                      model.bn.running_var)
        logits = bn_out @ model.fc_query.weight.T

        # query triplet: mocks stay mining candidates, only anchors drop
        q_loss, q_ap, q_an = triplet_loss(feat, labels, margin=margin,
                                          dist_func=dist,
                                          anchor_mask=is_real)
        q_loss = q_loss * w_query
        mask = is_real if mode == "ctl" else None
        xent = w_xent * cross_entropy_label_smooth(logits, labels,
                                                   num_classes, mask=mask)
        c_loss = w_center * center_loss(feat, labels, centers, mask=mask)
        metrics: Dict[str, torch.Tensor] = {
            "query_triplet": q_loss, "query_xent": xent,
            "query_center": c_loss}
        if mode == "ctl":
            ctl = ctl_centroid_loss(feat, labels, is_real, num_instances=k,
                                    margin=margin, dist_func=dist)
            centroid = ctl["loss"] * w_centroid
            total = centroid + c_loss + xent + q_loss
            metrics.update(centroid_triplet=centroid,
                           step_dist_ap=ctl["dist_ap"],
                           step_dist_an=ctl["dist_an"],
                           l2_mean_centroid=ctl["l2_mean_centroid"])
        else:
            total = c_loss + xent + q_loss
            denom = is_real.sum().clamp_min(1)
            metrics.update(
                step_dist_ap=torch.where(is_real, q_ap, 0.0).sum() / denom,
                step_dist_an=torch.where(is_real, q_an, 0.0).sum() / denom)
        metrics["loss"] = total
        return total, metrics, stats

    return loss_fn


def make_train_step(state, cfg, num_classes: int, mode: str) -> Callable:
    """``step(images, labels, is_real) -> metrics``: one optimizer step of
    the ``TrainState``'s model and centers. Puts the model in ``train()``
    mode; the metrics are detached tensors on the model's device (no host
    sync). mode: 'ctl' (centroid loss, mocks masked) or 'base'."""
    model, optimizers = state.model, state.optimizers
    loss_fn = make_loss_fn(model, state.centers, cfg, num_classes, mode)

    def step(images, labels, is_real):
        model.train()
        optimizers.zero_grad()
        with annotate("forward"):
            total, metrics, (mean, var) = loss_fn(images, labels, is_real)
        with annotate("backward"):
            total.backward()
        with annotate("optimizer"):
            optimizers.step()
            with torch.no_grad():
                model.bn.running_mean.copy_(mean)
                model.bn.running_var.copy_(var)
        return {name: v.detach() for name, v in metrics.items()}

    return step
