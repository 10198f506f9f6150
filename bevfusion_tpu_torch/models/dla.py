"""DLA (Deep Layer Aggregation) camera backbone (NCHW).

Counterpart of ``bevfusion_tpu/models/dla.py`` (reference
mmdet3d/models/backbones/dla.py): a 7x7 base conv, two plain conv levels,
then four recursive ``Tree`` levels of stride 2. A tree of one level runs
two ``DLABasic`` residual blocks (the first takes the max-pooled, where the
width changes 1x1-projected, input as its residual) and a ``Root`` that
concatenates them with the children handed down (the pooled input where
``level_root``), a 1x1 conv-BN (+ the first child where ``root_residual``)
and ReLU; a deeper tree nests two trees and threads its children to the
second.

Module names follow the JAX package's (``base_layer``, ``level0_0``,
``level3.tree1.tree2.conv1``, ``level3.tree2.root.conv``, ``project_conv``
/ ``project_bn``): no released checkpoint was at hand to check mmdet3d's
keys against (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONES
from .layers import BatchNorm2d, ConvBNAct

__all__ = ["DLA", "DLABasic", "Root", "Tree"]


class DLABasic(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, dilation, bias=False)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, dilation, bias=False)
        self.bn2 = BatchNorm2d(channels)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        y = self.bn1(self.conv1(x)).relu()
        return (self.bn2(self.conv2(y)) + residual).relu()


class Root(nn.Module):
    def __init__(self, in_channels: int, channels: int, kernel_size: int = 1,
                 residual: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, kernel_size, 1, (kernel_size - 1) // 2,
                              bias=False)
        self.bn = BatchNorm2d(channels)
        self.residual = residual

    def forward(self, children):
        y = self.bn(self.conv(torch.cat(children, 1)))
        return (y + children[0] if self.residual else y).relu()


class Tree(nn.Module):
    """``children_channels``: the widths of the children a parent hands
    down, summed (the JAX package's ``root_dim`` beyond the two blocks)."""

    def __init__(self, levels: int, in_channels: int, out_channels: int, stride: int = 1,
                 level_root: bool = False, children_channels: int = 0,
                 root_kernel_size: int = 1, root_residual: bool = False):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        handed = children_channels + (in_channels if level_root else 0)
        if levels == 1:
            self.project_conv = self.project_bn = None
            if in_channels != out_channels:
                self.project_conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
                self.project_bn = BatchNorm2d(out_channels)
            self.tree1 = DLABasic(in_channels, out_channels, stride)
            self.tree2 = DLABasic(out_channels, out_channels, 1)
            self.root = Root(2 * out_channels + handed, out_channels, root_kernel_size,
                             root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_kernel_size=root_kernel_size, root_residual=root_residual)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              children_channels=handed + out_channels,
                              root_kernel_size=root_kernel_size, root_residual=root_residual)

    def forward(self, x, children=None):
        children = list(children or [])
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            proj = bottom if self.project_conv is None else self.project_bn(
                self.project_conv(bottom))
            x1 = self.tree1(x, proj)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        return self.tree2(x1, children + [x1])


@BACKBONES.register
class DLA(nn.Module):
    """Returns the levels named in ``out_features`` (``level0`` ..
    ``level5``; ``level5`` alone by default). ``norm_eval`` and ``init_cfg``
    are accepted and, as in the JAX package, not read."""

    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 residual_root: bool = False, out_features: Optional[Sequence[str]] = None,
                 norm_eval: bool = False, init_cfg: Optional[dict] = None,
                 in_channels: int = 3):
        super().__init__()
        ch = list(channels)
        self.levels = list(levels)
        self.base_layer = ConvBNAct(in_channels, ch[0], 7, 1, 3)
        for i in range(levels[0]):
            self.add_module(f"level0_{i}", ConvBNAct(ch[0], ch[0], 3, 1, 1))
        for i in range(levels[1]):
            self.add_module(f"level1_{i}", ConvBNAct(ch[0] if i == 0 else ch[1], ch[1], 3,
                                                     2 if i == 0 else 1, 1))
        for lvl in range(2, 6):
            self.add_module(f"level{lvl}", Tree(levels[lvl], ch[lvl - 1], ch[lvl], stride=2,
                                                level_root=lvl > 2,
                                                root_residual=residual_root))
        self.out_features = list(out_features or ("level5",))

    def forward(self, x):
        x = self.base_layer(x)
        feats = {}
        for i in range(self.levels[0]):
            x = getattr(self, f"level0_{i}")(x)
        feats["level0"] = x
        for i in range(self.levels[1]):
            x = getattr(self, f"level1_{i}")(x)
        feats["level1"] = x
        for lvl in range(2, 6):
            x = getattr(self, f"level{lvl}")(x)
            feats[f"level{lvl}"] = x
        return tuple(feats[n] for n in self.out_features)
