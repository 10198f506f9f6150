"""Detection losses with mmcv's weight / avg_factor reduction.

Counterpart of ``bevfusion_tpu/models/losses.py`` (the mmdet losses the
reference configures: sigmoid FocalLoss, GaussianFocalLoss, L1Loss), in
fp32 (float64 where the inputs are: ``layers.at_least_fp32``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import parallel
from .layers import at_least_fp32

__all__ = ["clip_sigmoid", "sigmoid_focal_loss", "gaussian_focal_loss", "l1_loss"]


def _reduce(loss: torch.Tensor, avg_factor) -> torch.Tensor:
    total = loss.sum()
    if avg_factor is not None:
        return total / torch.clamp(torch.as_tensor(avg_factor, dtype=total.dtype), min=1.0)
    if parallel.active():  # the mean over every rank's elements
        return parallel.mean(loss)
    return total / max(loss.numel(), 1)


def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1 - eps] (transfusion.py:31-33), in fp32."""
    return torch.clamp(torch.sigmoid(at_least_fp32(x)), eps, 1 - eps)


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None, avg_factor=None,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """mmdet sigmoid FocalLoss. logits [N, C]; labels [N] int, label C is
    background; weight [N]. Returns sum / avg_factor (or the mean)."""
    C = logits.shape[-1]
    logits = at_least_fp32(logits)
    onehot = F.one_hot(labels.long(), C + 1)[..., :C].to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    pt = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = alpha_t * (1 - pt) ** gamma * ce
    if weight is not None:
        loss = loss * at_least_fp32(weight[..., None])
    return _reduce(loss, avg_factor)


def gaussian_focal_loss(pred: torch.Tensor, gaussian_target: torch.Tensor,
                        weight: Optional[torch.Tensor] = None, avg_factor=None,
                        alpha: float = 2.0, gamma: float = 4.0,
                        eps: float = 1e-12) -> torch.Tensor:
    """mmdet GaussianFocalLoss on probabilities (CornerNet focal):
    positives where target == 1, negatives weighted by (1 - t)^gamma; the
    logs guarded with max(., eps)."""
    pred = at_least_fp32(pred)
    t = at_least_fp32(gaussian_target)
    pos_w = (t == 1.0).to(t.dtype)
    neg_w = (1 - t) ** gamma
    pos = -torch.log(torch.clamp(pred, min=eps)) * (1 - pred) ** alpha * pos_w
    neg = -torch.log(torch.clamp(1 - pred, min=eps)) * pred ** alpha * neg_w
    loss = pos + neg
    if weight is not None:
        loss = loss * at_least_fp32(weight)
    return _reduce(loss, avg_factor)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weight: Optional[torch.Tensor] = None,
            avg_factor=None) -> torch.Tensor:
    loss = (at_least_fp32(pred) - at_least_fp32(target)).abs()
    if weight is not None:
        loss = loss * at_least_fp32(weight)
    return _reduce(loss, avg_factor)
