"""Necks (NCHW): the camera branch's image FPN and the map configs' BEV FPN.

Counterparts of ``bevfusion_tpu/models/necks.py``: ``GeneralizedLSSFPN``
(reference mmdet3d/models/necks/generalized_lss.py:13-103, module names
``lateral_convs.i`` / ``fpn_convs.i``) and ``LSSFPN`` (reference
necks/lss.py:13-65, the ``fuse`` and ``upsample`` Sequentials).
``DetectronFPN`` is not ported yet (ROADMAP Queue 1 #9).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..registry import NECKS
from .layers import ConvBNAct, conv_bn_relu, resize_bilinear


@NECKS.register
class GeneralizedLSSFPN(nn.Module):
    """Top-down FPN: upsample level i+1 to level i, concat, 1x1 then 3x3
    conv-BN-ReLU. The deepest lateral takes the raw top level; shallower
    laterals take the fused outputs. Returns ``len(in_channels) - 1`` maps."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, num_outs: int,
                 start_level: int = 0, end_level: int = -1, no_norm_on_lateral: bool = False,
                 conv_cfg: Optional[dict] = None, norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, upsample_cfg: Optional[dict] = None):
        super().__init__()
        if no_norm_on_lateral or start_level != 0:
            raise NotImplementedError("GeneralizedLSSFPN: no_norm_on_lateral / start_level != 0 "
                                      "(no config uses them)")
        self.align_corners = bool((upsample_cfg or {}).get("align_corners", True))
        n = len(in_channels) - 1
        ins = [in_channels[i] + (in_channels[i + 1] if i == n - 1 else out_channels)
               for i in range(n)]
        self.lateral_convs = nn.ModuleList([ConvBNAct(c, out_channels, 1) for c in ins])
        self.fpn_convs = nn.ModuleList([ConvBNAct(out_channels, out_channels, 3, 1, 1)
                                        for _ in ins])

    def forward(self, inputs):
        laterals = list(inputs)
        for i in range(len(laterals) - 2, -1, -1):
            up = resize_bilinear(laterals[i + 1], laterals[i].shape[-2:], self.align_corners)
            x = self.lateral_convs[i](torch.cat([laterals[i], up], 1))
            laterals[i] = self.fpn_convs[i](x)
        return tuple(laterals[:-1])


@NECKS.register
class LSSFPN(nn.Module):
    """BEV neck: the map ``xs[in_indices[0]]`` resized to the size of
    ``xs[in_indices[1]]``, concatenated with it, ``fuse`` (1x1 then 3x3
    conv-BN-ReLU), then, where ``scale_factor > 1``, ``upsample`` (resize by
    it, 3x3 conv-BN-ReLU). Every resize is bilinear with
    ``align_corners=True``. Returns one map."""

    def __init__(self, in_indices: Sequence[int], in_channels: Sequence[int], out_channels: int,
                 scale_factor: int = 1):
        super().__init__()
        self.in_indices = tuple(in_indices)
        self.fuse = nn.Sequential(*conv_bn_relu(sum(in_channels), out_channels, 1),
                                  *conv_bn_relu(out_channels, out_channels, 3, 1, 1))
        self.upsample = (nn.Sequential(nn.Upsample(scale_factor=scale_factor, mode="bilinear",
                                                   align_corners=True),
                                       *conv_bn_relu(out_channels, out_channels, 3, 1, 1))
                         if scale_factor > 1 else nn.Identity())

    def forward(self, xs):
        x1, x2 = (xs[i] for i in self.in_indices)
        x1 = resize_bilinear(x1, x2.shape[-2:], align_corners=True)
        return self.upsample(self.fuse(torch.cat([x1, x2], 1)))
