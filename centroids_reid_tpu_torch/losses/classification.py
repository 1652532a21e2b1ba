"""Label-smoothed cross entropy and center loss (counterpart of
``centroids_reid_tpu/losses/classification.py``).

* ``cross_entropy_label_smooth``: targets ``(1 - eps) * onehot + eps / C``,
  the mean over rows of ``-sum(t * log_softmax)``; with a mask, the mean
  over the masked rows.
* ``center_loss``: ``||x_i - c_{y_i}||^2`` clamped to [1e-12, 1e12], mean
  over the (masked) rows. Only the own-class center enters, so a gather
  gives the reference's N x C masked matrix's value and gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .distances import as_float
from .triplet import masked_mean


def cross_entropy_label_smooth(logits, labels, num_classes: int,
                               epsilon: float = 0.1, mask=None):
    log_probs = torch.log_softmax(as_float(logits), dim=1)
    onehot = F.one_hot(labels.long(), num_classes).to(log_probs.dtype)
    targets = (1.0 - epsilon) * onehot + epsilon / num_classes
    per_row = -(targets * log_probs).sum(dim=1)
    return masked_mean(per_row, mask)


def center_loss(feats, labels, centers, mask=None):
    """feats [N, D], labels [N], centers [C, D] (the learnable parameter,
    trained by its own SGD: ``solver.build_optimizers``)."""
    own = as_float(centers)[labels.long()]
    sq = ((as_float(feats) - own) ** 2).sum(dim=1).clamp(1e-12, 1e12)
    return masked_mean(sq, mask)


def init_centers(generator: torch.Generator, num_classes: int,
                 feat_dim: int) -> torch.Tensor:
    """Standard-normal centers [C, D] drawn from ``generator`` on its
    device, as the reference's ``torch.randn``."""
    return torch.randn((num_classes, feat_dim), generator=generator,
                       device=generator.device)
