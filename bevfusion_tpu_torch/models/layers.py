"""Shared 2D building blocks (NCHW).

Counterpart of ``bevfusion_tpu/models/layers.py`` for what SECOND,
SECONDFPN and the TransFusion head use. PyTorch has the JAX package's
``Conv`` (torch-style integer padding) and ``max_pool2d_same`` natively
as ``nn.Conv2d`` and ``F.max_pool2d``; ``Norm`` and ``ConvBNAct`` remain.
"""
from __future__ import annotations

import torch.nn as nn

__all__ = ["Norm", "ConvBNAct"]


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
