"""Shared 2D building blocks (NCHW).

Counterpart of ``bevfusion_tpu/models/layers.py`` for what the port's
models use. PyTorch has the JAX package's ``Conv`` (torch-style integer
padding), ``max_pool2d_same`` and ``resize_bilinear`` natively as
``nn.Conv2d``, ``F.max_pool2d`` and ``F.interpolate``; ``Norm``,
``ConvBNAct`` and ``conv_bn_relu`` remain.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Norm", "ConvBNAct", "conv_bn_relu", "resize_bilinear"]


def Norm(norm_type: str, num_features: int, eps: float = 1e-5,
         momentum: float = 0.1) -> nn.BatchNorm2d:
    """BatchNorm2d selected by a reference-style norm type (momentum in the
    torch convention)."""
    if not (norm_type.startswith("BN") or norm_type.startswith("SyncBN")
            or norm_type == "naiveSyncBN"):
        raise NotImplementedError(f"norm type {norm_type!r} (ROADMAP: LN/GN norms)")
    return nn.BatchNorm2d(num_features, eps=eps, momentum=momentum)


class ConvBNAct(nn.Module):
    """conv (no bias: a norm follows) -> BN -> ReLU, the mmcv ConvModule
    contract; children are named ``conv`` and ``bn`` like the reference
    checkpoint's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x):
        return self.bn(self.conv(x)).relu()


def conv_bn_relu(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = False) -> List[nn.Module]:
    """[Conv2d, BatchNorm2d, ReLU] for a reference ``nn.Sequential`` whose
    checkpoint keys are flat indices (DepthLSS's ``dtransform.3.weight``,
    ConvFuser's ``fuser.1.running_mean``); ``bias`` as the reference has it."""
    return [nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=bias),
            nn.BatchNorm2d(out_channels), nn.ReLU()]


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (H', W'). The JAX
    package's ``resize_bilinear`` reproduces torch's ``F.interpolate``
    sampling grid for both ``align_corners`` values, so this is that call."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)
