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
* Groups (``TPU.NUM_GROUPS``, the batch's leading axis): each group's
  forward sees only its own P * K rows, so mining, centroids, the masked
  BNNeck and the trunk's BN batch statistics are per group, as in the JAX
  step's ``vmap``. The loss and the gradient are the mean over groups; the
  trunk's and the BNNeck's running statistics become the mean of the
  per-group updates from the shared starting value, the JAX package's
  documented cross-group policy (``centroids_reid_tpu/engine/steps.py``).
  The step loops over the groups: each group's forward and backward start
  from the same parameters and running statistics (restored between
  groups), and the gradients accumulate scaled by 1 / G. A loop rather
  than one forward over G * P * K rows with a grouped BN, because it keeps
  ``nn.BatchNorm2d`` and cuDNN's kernels as they are, holds one group's
  activations at a time, and at G = 1 is the one-group step unchanged; at
  full width one group (64 x 4 images) already fills the card.
* Processes (a ``torch.distributed`` group, one process per card): each
  process steps its own groups of the global batch (``parallel.local_groups``),
  every group's loss scaled by 1 / G with G the global group count. After
  the group loop one ``all_reduce(SUM)`` over one flat buffer
  (``parallel.all_reduce_``) makes every gradient (the model's and the
  centers') the sum over the processes, and the trunk's and the BNNeck's
  running statistics and the metrics their mean (``num_batches_tracked``
  is equal everywhere); then the optimizers step, the same on every
  process. An explicit reduce rather than ``DistributedDataParallel``,
  which would all-reduce on every group's backward and overwrite the
  per-group statistics with its buffer broadcast. At 2 processes of one
  group each the step equals the one-process step of G = 2 bit for bit.
  Without a process group there is no collective and no extra copy.
* ``TPU.DEBUG_NANS``: after the backward (and the reduce, so that every
  process raises together) the step checks that every loss term and every
  gradient is finite and raises ``FloatingPointError`` naming the first
  that is not, before the optimizers step (the JAX package's
  ``jax_debug_nans`` for the step). Off, it adds no host sync.
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
from ..parallel.mesh import all_reduce_, distributed, process_count
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
    stats)``: one group's forward, on a model in ``train()`` mode. images
    [P*K, H, W, 3] (augmented, normalised), labels [P*K], is_real [P*K]."""
    if mode not in ("ctl", "base"):
        raise ValueError(f"mode must be 'ctl' or 'base', not {mode!r}")
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


def _running_stats(model) -> list:
    """The trunk's BN layers that keep running statistics."""
    return [m for m in model.backbone.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats]


def _check_finite(metrics: Dict[str, torch.Tensor], model, centers) -> None:
    """Raise ``FloatingPointError`` naming the first loss term or gradient
    that holds a NaN or an infinity (one host sync)."""
    named = [(f"loss term {k}", v) for k, v in metrics.items()]
    named += [(f"the gradient of {n}", p.grad)
              for n, p in model.named_parameters() if p.grad is not None]
    named.append(("the gradient of the centers", centers.grad))
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if not bool(finite.all()):
        bad = named[int((~finite).nonzero()[0])][0]
        raise FloatingPointError(f"TPU.DEBUG_NANS: {bad} is not finite in "
                                 f"the train step")


def _reduce_over_processes(model, centers, bns, metrics, neck) -> None:
    """The step's one collective: gradients summed, running statistics and
    metrics averaged over the processes, in place."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    stats = [b for m in bns for b in (m.running_mean, m.running_var)]
    all_reduce_(sums=grads + [centers.grad],
                means=stats + list(neck) + list(metrics.values()))


def make_train_step(state, cfg, num_classes: int, mode: str) -> Callable:
    """``step(images, labels, is_real) -> metrics``: one optimizer step of
    the ``TrainState``'s model and centers over a group-major batch: images
    [G, P*K, H, W, 3], labels and is_real [G, P*K] (in a process group,
    this process's groups of the global batch). Puts the model in
    ``train()`` mode; the metrics (means over all groups) are detached
    tensors on the model's device (no host sync unless
    ``TPU.DEBUG_NANS``). mode: 'ctl' (centroid loss, mocks masked) or
    'base'."""
    model, optimizers, centers = state.model, state.optimizers, state.centers
    loss_fn = make_loss_fn(model, centers, cfg, num_classes, mode)
    debug_nans = bool(cfg.TPU.DEBUG_NANS)
    bns = _running_stats(model)

    def step(images, labels, is_real):
        if (images.dim() != 5 or labels.shape != images.shape[:2]
                or is_real.shape != images.shape[:2]):
            raise ValueError(
                f"a train step takes a group-major batch: images [G, P*K, H, "
                f"W, 3], labels and is_real [G, P*K]; got "
                f"{tuple(images.shape)}, {tuple(labels.shape)}, "
                f"{tuple(is_real.shape)}")
        model.train()
        optimizers.zero_grad()
        g = images.shape[0]
        groups = g * process_count()   # the global group count
        if g > 1:   # the shared starting statistics and their group sums
            start = [[b.clone() for b in (m.running_mean, m.running_var,
                                          m.num_batches_tracked)]
                     for m in bns]
            sums = [[torch.zeros_like(b) for b in st[:2]] for st in start]
        metrics: Dict[str, torch.Tensor] = {}
        neck = None
        for i in range(g):
            if i:
                with torch.no_grad():
                    for m, st in zip(bns, start):
                        m.running_mean.copy_(st[0])
                        m.running_var.copy_(st[1])
                        m.num_batches_tracked.copy_(st[2])
            with annotate("forward"):
                total, group_metrics, stats = loss_fn(images[i], labels[i],
                                                      is_real[i])
            with annotate("backward"):
                (total / groups if groups > 1 else total).backward()
            if g == 1:
                metrics, neck = group_metrics, stats
                break
            with torch.no_grad():
                for m, acc in zip(bns, sums):
                    acc[0] += m.running_mean
                    acc[1] += m.running_var
                metrics = {k: metrics.get(k, 0) + v.detach()
                           for k, v in group_metrics.items()}
                neck = stats if neck is None else (neck[0] + stats[0],
                                                   neck[1] + stats[1])
        if g > 1:
            with torch.no_grad():
                for m, acc, st in zip(bns, sums, start):
                    m.running_mean.copy_(acc[0] / g)
                    m.running_var.copy_(acc[1] / g)
                    m.num_batches_tracked.copy_(st[2] + 1)
            metrics = {k: v / g for k, v in metrics.items()}
            neck = (neck[0] / g, neck[1] / g)
        if distributed():
            metrics = {k: v.detach() for k, v in metrics.items()}
            with annotate("all_reduce"):
                _reduce_over_processes(model, centers, bns, metrics, neck)
        if debug_nans:
            _check_finite(metrics, model, centers)
        with annotate("optimizer"):
            optimizers.step()
            with torch.no_grad():
                model.bn.running_mean.copy_(neck[0])
                model.bn.running_var.copy_(neck[1])
        return {name: v.detach() for name, v in metrics.items()}

    return step
