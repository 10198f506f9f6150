"""ResNets (NCHW): the BEV decoder backbone of the camera-family configs
and the ResNet camera backbone.

``GeneralizedResNet`` is the counterpart of
``bevfusion_tpu/models/resnet.py:GeneralizedResNet`` (reference
mmdet3d/models/backbones/resnet.py:13-40): stages of mmcv ``BasicBlock``s,
each described by ``(num_blocks, out_channels, stride)``, the first block
of a stage taking the stride. The module is the reference's
``nn.ModuleList`` of ``nn.Sequential`` stages, so its keys are
``{stage}.{block}.conv1.weight`` and so on.

``ResNet`` is the counterpart of ``bevfusion_tpu/models/resnet_full.py``
(the torchvision / mmdet ResNet the camera-only resnet configs import):
a 7x7/2 conv stem and a 3x3/2 max pool, then four stages of ``Bottleneck``s
(depth 50, 101, 152) or ``BasicBlock``s (18, 34) with strides 1, 2, 2, 2,
the stride on the 3x3 conv; ``out_indices`` picks the stages returned.
Module names follow torchvision: ``conv1``, ``bn1``,
``layer{i}.{j}.{conv1..3,bn1..3,downsample.0,downsample.1}``.
``init_cfg: Pretrained`` is ignored: no weights are downloaded.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONES
from .layers import BasicBlock, BatchNorm2d


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


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to ``planes * 4`` channels, each with BN,
    ReLU between, plus the shortcut (``downsample``: 1x1 conv with the
    stride -> BN where the stride or the width changes), then ReLU."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1):
        super().__init__()
        out_channels = planes * self.expansion
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_channels, 1, bias=False)
        self.bn3 = BatchNorm2d(out_channels)
        self.downsample = (nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, stride,
                                                   bias=False), BatchNorm2d(out_channels))
                           if stride != 1 or in_channels != out_channels else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x)).relu()
        out = self.bn2(self.conv2(out)).relu()
        return (self.bn3(self.conv3(out)) + identity).relu()


_ARCH = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
         50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
         152: ("bottleneck", (3, 8, 36, 3))}


@BACKBONES.register
class ResNet(nn.Module):
    """Returns the outputs of the stages in ``out_indices``, shallowest first."""

    def __init__(self, depth: int = 50, in_channels: int = 3, base_channels: int = 64,
                 num_stages: int = 4, out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = False,
                 norm_cfg: Optional[dict] = None, init_cfg: Optional[dict] = None):
        super().__init__()
        norm = (norm_cfg or {}).get("type", "BN")
        if num_stages != 4 or frozen_stages != -1 or norm_eval or not norm.startswith("BN"):
            raise NotImplementedError(f"ResNet: num_stages {num_stages}, frozen_stages "
                                      f"{frozen_stages}, norm_eval {norm_eval}, norm {norm} (the "
                                      "JAX package builds 4 stages of BN, none frozen)")
        kind, layers = _ARCH[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(in_channels, base_channels, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(base_channels)
        cin, planes = base_channels, base_channels
        for i, num_blocks in enumerate(layers):
            blocks = []
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                if kind == "bottleneck":
                    blocks.append(Bottleneck(cin, planes, stride))
                    cin = planes * Bottleneck.expansion
                else:
                    blocks.append(BasicBlock(cin, planes, stride))
                    cin = planes
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.max_pool2d(self.bn1(self.conv1(x)).relu(), 3, 2, 1)
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
