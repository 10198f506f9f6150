"""Image FPN neck of the camera branch (NCHW).

Counterpart of ``bevfusion_tpu/models/necks.py:GeneralizedLSSFPN``
(reference mmdet3d/models/necks/generalized_lss.py:13-103), with the
reference's module names ``lateral_convs.i`` / ``fpn_convs.i``.
``LSSFPN`` and ``DetectronFPN`` are not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..registry import NECKS
from .layers import ConvBNAct, resize_bilinear


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
