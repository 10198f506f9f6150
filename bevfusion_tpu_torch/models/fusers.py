"""BEV fuser (NCHW).

Counterpart of ``bevfusion_tpu/models/fusers.py:ConvFuser`` (reference
mmdet3d/models/fusers/conv.py:12-23): concat in (camera, lidar, radar) order,
3x3 conv without bias, BN, ReLU. The module is the reference's
``nn.Sequential``, so its keys are ``fuser.0.weight``, ``fuser.1.*``.
``AddFuser`` is not ported yet (ROADMAP Queue 1 #9).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..registry import FUSERS
from .layers import conv_bn_relu


@FUSERS.register
class ConvFuser(nn.Sequential):
    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__(*conv_bn_relu(sum(in_channels), out_channels, 3, 1, 1))

    def forward(self, inputs):
        return super().forward(torch.cat(list(inputs), dim=1))
