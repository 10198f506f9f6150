"""SECOND BEV backbone and SECONDFPN neck (NCHW).

Counterpart of ``bevfusion_tpu/models/second.py`` (reference
mmdet3d/models/backbones/second.py:14-97, necks/second.py:14-99), with
the reference's module names (``blocks.i.*``, ``deblocks.i.*``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..registry import BACKBONES, NECKS
from .layers import Norm


def _norm_args(norm_cfg: Optional[dict]):
    cfg = norm_cfg or {"type": "BN", "eps": 1e-3, "momentum": 0.01}
    return cfg.get("type", "BN"), cfg.get("eps", 1e-3), cfg.get("momentum", 0.01)


@BACKBONES.register
class SECOND(nn.Module):
    """Stages of [strided 3x3 conv + layer_num 3x3 convs], each
    conv-BN-ReLU; returns every stage's output."""

    def __init__(self, in_channels: int = 128, out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5), layer_strides: Sequence[int] = (2, 2, 2),
                 norm_cfg: Optional[dict] = None, conv_cfg: Optional[dict] = None):
        super().__init__()
        nt, eps, momentum = _norm_args(norm_cfg)
        blocks = []
        cin = in_channels
        for cout, num, stride in zip(out_channels, layer_nums, layer_strides):
            mods = [nn.Conv2d(cin, cout, 3, stride, 1, bias=False),
                    Norm(nt, cout, eps, momentum), nn.ReLU()]
            for _ in range(num):
                mods += [nn.Conv2d(cout, cout, 3, 1, 1, bias=False),
                         Norm(nt, cout, eps, momentum), nn.ReLU()]
            blocks.append(nn.Sequential(*mods))
            cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return tuple(outs)


@NECKS.register
class SECONDFPN(nn.Module):
    """Per-stage deconv (stride > 1) or 1x1 conv to a common stride, then
    a channel concat. The ConvTranspose2d weight ``[I, O, kh, kw]`` is the
    JAX package's HWIO kernel flipped in space (runtime/bridge.py)."""

    def __init__(self, in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4), norm_cfg: Optional[dict] = None,
                 upsample_cfg: Optional[dict] = None, conv_cfg: Optional[dict] = None,
                 use_conv_for_no_stride: bool = False):
        super().__init__()
        nt, eps, momentum = _norm_args(norm_cfg)
        deblocks = []
        for cin, cout, stride in zip(in_channels, out_channels, upsample_strides):
            if stride > 1 or (stride == 1 and not use_conv_for_no_stride):
                up = nn.ConvTranspose2d(cin, cout, stride, stride, bias=False)
            else:
                k = int(round(1 / stride))
                up = nn.Conv2d(cin, cout, k, k, bias=False)
            deblocks.append(nn.Sequential(up, Norm(nt, cout, eps, momentum), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, xs):
        ups = [deblock(x) for deblock, x in zip(self.deblocks, xs)]
        return [torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]]
