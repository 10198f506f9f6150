"""BEV map-segmentation head (NCHW).

Counterpart of ``bevfusion_tpu/models/heads/segm.py`` (reference
mmdet3d/models/heads/segm/vanilla.py:47-138): ``BEVGridTransform``
re-grids the decoder's BEV map from the detection scope to the map scope
by bilinear sampling, then a classifier of two 3x3 conv-BN-ReLU and a 1x1
conv gives one logit per class; eval returns their sigmoid, training a
per-class sigmoid focal or cross-entropy loss. The classifier is the
reference's ``nn.Sequential``, so its keys are ``classifier.{0,1,3,4,6}``.

The BEV map is ``[B, C, X, Y]`` (the JAX package holds ``[B, X, Y, C]``):
X is ``F.grid_sample``'s H axis and Y its W axis, so the sampling grid's
last axis is (Y coordinate, X coordinate).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import parallel
from ...registry import HEADS
from ..layers import at_least_fp32, conv_bn_relu, resize_bilinear

__all__ = ["sigmoid_xent_loss", "sigmoid_focal_loss", "BEVGridTransform", "BEVSegmentationHead"]


def _sigmoid_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy of ``sigmoid(logits)``, in the
    stable form ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_xent_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy, in fp32 (float64 where the logits are)."""
    return parallel.mean(_sigmoid_xent(at_least_fp32(logits), at_least_fp32(targets)))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = -1.0,
                       gamma: float = 2.0) -> torch.Tensor:
    """Mean sigmoid focal loss ``ce * (1 - p_t) ** gamma`` (times ``alpha_t``
    where ``alpha >= 0``), in fp32."""
    logits, targets = at_least_fp32(logits), at_least_fp32(targets)
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = _sigmoid_xent(logits, targets) * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return parallel.mean(loss)


_LOSSES = {"xent": sigmoid_xent_loss, "focal": sigmoid_focal_loss}


class BEVGridTransform(nn.Module):
    """Re-grid a BEV map ``[B, C, X, Y]`` from ``input_scope`` to
    ``output_scope`` (per axis ``(min, max, step)`` in metres): each output
    cell centre is sampled bilinearly, zero outside the input
    (``F.grid_sample``, ``align_corners=False``), after an optional bilinear
    prescale of the input."""

    def __init__(self, input_scope: Sequence[Tuple[float, float, float]],
                 output_scope: Sequence[Tuple[float, float, float]],
                 prescale_factor: float = 1.0):
        super().__init__()
        self.prescale_factor = float(prescale_factor)
        coords = []
        for (imin, imax, _), (omin, omax, ostep) in zip(input_scope, output_scope):
            v = np.arange(omin + ostep / 2, omax, ostep, dtype=np.float32)
            coords.append((v - imin) / (imax - imin) * 2 - 1)
        u, v = np.meshgrid(coords[0], coords[1], indexing="ij")
        self.register_buffer("grid", torch.from_numpy(np.stack([v, u], -1))[None],
                             persistent=False)  # [1, Xo, Yo, (y, x)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.prescale_factor != 1:
            x = resize_bilinear(x, (int(x.shape[-2] * self.prescale_factor),
                                    int(x.shape[-1] * self.prescale_factor)))
        # the sampling grid and weights in fp32 (or wider) at any compute dtype
        xf = at_least_fp32(x)
        grid = self.grid.to(xf.dtype).expand(x.shape[0], -1, -1, -1)
        return F.grid_sample(xf, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False).to(x.dtype)


@HEADS.register
class BEVSegmentationHead(nn.Module):
    """Map head: ``transform`` then ``classifier``. Eval: per-class
    probabilities ``[B, num_classes, Xo, Yo]`` in fp32. Training
    (``target`` ``[B, num_classes, Xo, Yo]``): ``{"<class>/<loss>": loss}``."""

    def __init__(self, in_channels: int, grid_transform: Dict[str, Any], classes: Sequence[str],
                 loss: str = "focal"):
        super().__init__()
        if loss not in _LOSSES:
            raise ValueError(f"BEVSegmentationHead: unsupported loss {loss!r}")
        self.classes = list(classes)
        self.loss = loss
        self.transform = BEVGridTransform(**grid_transform)
        c = in_channels
        self.classifier = nn.Sequential(*conv_bn_relu(c, c, 3, 1, 1), *conv_bn_relu(c, c, 3, 1, 1),
                                        nn.Conv2d(c, len(self.classes), 1))

    def forward(self, x, target: Optional[torch.Tensor] = None):
        if isinstance(x, (list, tuple)):
            x = x[0]
        x = self.classifier(self.transform(x))
        if not self.training:
            return torch.sigmoid(x.float())
        if target is None:
            raise ValueError("BEVSegmentationHead: training needs the target masks "
                             "(batch['gt_masks_bev'])")
        return {f"{name}/{self.loss}": _LOSSES[self.loss](x[:, i], target[:, i])
                for i, name in enumerate(self.classes)}
