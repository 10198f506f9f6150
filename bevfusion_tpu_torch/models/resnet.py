"""BEV decoder backbone of the camera-only map configs (NCHW).

Counterpart of ``bevfusion_tpu/models/resnet.py:GeneralizedResNet``
(reference mmdet3d/models/backbones/resnet.py:13-40): stages of mmcv
``BasicBlock``s, each described by ``(num_blocks, out_channels, stride)``,
the first block of a stage taking the stride. The module is the
reference's ``nn.ModuleList`` of ``nn.Sequential`` stages, so its keys
are ``{stage}.{block}.conv1.weight`` and so on.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..registry import BACKBONES
from .layers import BasicBlock


@BACKBONES.register
class GeneralizedResNet(nn.ModuleList):
    """Returns every stage's output, shallowest first."""

    def __init__(self, in_channels: int, blocks: Sequence[Tuple[int, int, int]]):
        stages = []
        for num_blocks, out_channels, stride in blocks:
            stages.append(nn.Sequential(
                BasicBlock(in_channels, out_channels, stride),
                *(BasicBlock(out_channels, out_channels) for _ in range(num_blocks - 1))))
            in_channels = out_channels
        super().__init__(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for stage in self:
            x = stage(x)
            outs.append(x)
        return outs
