"""PointNet++ set abstraction and feature propagation (channels last).

Counterpart of ``bevfusion_tpu/models/pointnet_modules.py`` (reference
mmdet3d/ops/pointnet_modules/point_sa_module.py and point_fp_module.py):

- ``SharedMLP``: per layer a Linear without bias, BatchNorm over every row
  (the JAX ``Norm("BN")`` on channels-last rows) and ReLU;
- ``PointSAModuleMSG``: furthest point sampling (``ops/pointnet.py``, the
  D2 kernel on the card), then per radius a ball query, the grouped
  offsets from the centre (and the grouped features), a ``SharedMLP`` and
  a max over the group's valid members (0 where none);
- ``PointSAModule``: the same, one scale;
- ``PointFPModule``: three-nearest inverse-distance interpolation of the
  coarse features onto the fine points, the fine points' own features
  concatenated, a ``SharedMLP``.

One sample at a time, as the JAX modules (xyz [N, 3], features [N, C]).
Module names are the JAX package's (``mlp{r}.fc{i}`` / ``mlp{r}.bn{i}``,
``mlp.fc{i}``); mmdet3d's checkpoints name the same layers
``mlps.{r}.layer{i}.{conv,bn}`` with 1x1 Conv2d weights (ROADMAP Queue 3).
Both take their input widths, which flax infers: ``in_channels`` the
features' (0 without).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops import pointnet as pn
from ..registry import BACKBONES
from .layers import BatchNorm1d

__all__ = ["SharedMLP", "PointSAModuleMSG", "PointSAModule", "PointFPModule"]


class SharedMLP(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.depth = len(channels)
        c = in_channels
        for i, out in enumerate(channels):
            self.add_module(f"fc{i}", nn.Linear(c, out, bias=False))
            self.add_module(f"bn{i}", BatchNorm1d(out, eps=1e-5, momentum=0.1))
            c = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., Cin] -> [..., Cout], the BatchNorm over every row."""
        for i in range(self.depth):
            y = getattr(self, f"fc{i}")(x)
            x = getattr(self, f"bn{i}")(y.reshape(-1, y.shape[-1])).view(y.shape).relu()
        return x


class PointSAModuleMSG(nn.Module):
    """Multi-scale grouping: xyz [N, 3], feats [N, in_channels] or None,
    mask [N] or None -> (new_xyz [num_point, 3], new_feats [num_point,
    sum of each scale's last width])."""

    def __init__(self, num_point: int, radii: Sequence[float], sample_nums: Sequence[int],
                 mlp_channels: Sequence[Sequence[int]], use_xyz: bool = True,
                 in_channels: int = 0):
        super().__init__()
        self.num_point, self.radii, self.sample_nums = num_point, list(radii), list(sample_nums)
        self.use_xyz = use_xyz
        cin = in_channels + 3 if use_xyz or in_channels == 0 else in_channels
        for r, mlp in enumerate(mlp_channels):
            self.add_module(f"mlp{r}", SharedMLP(cin, mlp))

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        new_xyz = pn.gather_points(xyz, pn.furthest_point_sample(xyz, self.num_point, mask))
        outs = []
        for r, (radius, nsample) in enumerate(zip(self.radii, self.sample_nums)):
            idx, valid = pn.ball_query(radius, nsample, xyz, new_xyz, mask)
            g = pn.group_points(xyz, idx) - new_xyz[:, None, :]
            if feats is not None:
                gf = pn.group_points(feats, idx)
                g = torch.cat([g, gf], -1) if self.use_xyz else gf
            g = getattr(self, f"mlp{r}")(g)
            pooled = torch.where(valid[..., None], g, float("-inf")).amax(1)
            outs.append(torch.where(torch.isfinite(pooled), pooled, 0.0))
        return new_xyz, torch.cat(outs, -1)


class PointSAModule(PointSAModuleMSG):
    """Single-scale set abstraction (point_sa_module.py:354)."""


@BACKBONES.register
class PointFPModule(nn.Module):
    """target_xyz [N, 3], source_xyz [M, 3], target_feats [N, Ct] or None,
    source_feats [M, Cs], source_mask [M] or None -> [N, last width];
    ``in_channels`` = Cs + Ct."""

    def __init__(self, mlp_channels: Sequence[int], in_channels: int):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp_channels)

    def forward(self, target_xyz, source_xyz, target_feats, source_feats, source_mask=None):
        dists, idx = pn.three_nn(target_xyz, source_xyz, source_mask)
        interp = pn.three_interpolate(source_feats, idx, pn.interpolation_weights(dists))
        if target_feats is not None:
            interp = torch.cat([interp, target_feats], -1)
        return self.mlp(interp)
