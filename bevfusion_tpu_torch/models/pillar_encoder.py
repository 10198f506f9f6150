"""PointPillars encoder family: pillar feature net and dense scatter.

Counterpart of ``bevfusion_tpu/models/pillar_encoder.py`` (reference
mmdet3d/models/backbones/pillar_encoder.py): ``PillarFeatureNet`` decorates
each pillar's point table with the offsets from the cluster mean and the
pillar centre, then runs ``PFNLayer``s (Linear without bias, BN1d over
every (pillar, point) row, ReLU, the max over the pillar's points);
``PointPillarsScatter`` writes the pillar features into a dense BEV
canvas; ``PointPillarsEncoder`` composes both per sample. Padded pillars
and points are masked, never filtered: the shapes stay static and no
host sync is needed. The canvas is [B, C, X, Y], the layout of every BEV
map of the port (the JAX package's is [B, X, Y, C]).

Module names follow the reference checkpoint: ``pts_voxel_encoder.
pfn_layers.{i}.{linear,norm}``, ``pts_middle_encoder`` (no parameters).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..registry import BACKBONES
from .layers import GroupNorm, Norm

__all__ = ["PointLayer", "point_mask", "pillar_centre_offsets", "masked_max", "PFNLayer",
           "PillarFeatureNet", "PointPillarsScatter", "PillarBranch", "PointPillarsEncoder"]


def point_mask(num_points: torch.Tensor, max_points: int) -> torch.Tensor:
    """[M] stored counts -> [M, max_points] bool, True on a stored point."""
    return torch.arange(max_points, device=num_points.device) < num_points[:, None]


def pillar_centre_offsets(features: torch.Tensor, coords: torch.Tensor, voxel_size,
                          point_cloud_range) -> torch.Tensor:
    """Each point's x, y offset from its pillar's centre: features [M, P, C],
    coords [M, 3] (x, y, z) -> [M, P, 2]."""
    vx, vy = voxel_size[0], voxel_size[1]
    c = coords[:, None, :2].to(features.dtype)
    return torch.stack([features[..., 0] - (c[..., 0] * vx + (vx / 2 + point_cloud_range[0])),
                        features[..., 1] - (c[..., 1] * vy + (vy / 2 + point_cloud_range[1]))],
                       -1)


def masked_max(y: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    """Max over each pillar's stored points, [M, P, C] -> [M, 1, C]; an
    empty pillar gives 0."""
    m = y.masked_fill(~pm[..., None], float("-inf")).amax(1, keepdim=True)
    return torch.where(torch.isfinite(m), m, 0.0)


class PointLayer(nn.Module):
    """Linear without bias -> BN1d over every (pillar, point) row, padded
    rows included, as the JAX ``Norm`` takes them -> ReLU: [M, P, Cin] ->
    [M, P, Cout]. A LayerNorm (``norm_cfg`` LN) normalises each row, a
    GroupNorm (GN) each pillar's rows together, as flax's on [M, P, C]."""

    def __init__(self, in_channels: int, out_channels: int, norm_cfg: Optional[dict] = None):
        super().__init__()
        cfg = dict(norm_cfg or {"type": "BN1d", "eps": 1e-3, "momentum": 0.01})
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = Norm(cfg.get("type", "BN1d"), out_channels, cfg.get("eps", 1e-3),
                         cfg.get("momentum", 0.01), dims=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(x)
        if isinstance(self.norm, GroupNorm):  # flax's GroupNorm on [M, P, C]: per pillar
            return self.norm(y.transpose(1, 2)).transpose(1, 2).relu()
        return self.norm(y.reshape(-1, y.shape[-1])).view(y.shape).relu()


class PFNLayer(PointLayer):
    """A non-last layer has ``out_channels // 2`` units and returns its
    points (masked to 0) beside their max; the last returns the max alone,
    [M, 1, out_channels]."""

    def __init__(self, in_channels: int, out_channels: int, last_layer: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__(in_channels, out_channels if last_layer else out_channels // 2,
                         norm_cfg)
        self.last_layer = last_layer

    def forward(self, x: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        y_max = masked_max(y, pm)
        if self.last_layer:
            return y_max
        return torch.cat([torch.where(pm[..., None], y, 0.0), y_max.expand_as(y)], -1)


@BACKBONES.register
class PillarFeatureNet(nn.Module):
    """Point table [M, P, C] -> pillar features [M, C_out]. Each point is
    decorated to [raw C, offset from the cluster mean (3), offset from the
    pillar centre (2), distance when ``with_distance``]: the first Linear
    takes ``in_channels + 5`` (+1), the reference's rule."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False, voxel_size=(0.2, 0.2, 4),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1), norm_cfg: Optional[dict] = None):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        chans = [in_channels + 5 + int(with_distance)] + list(feat_channels)
        self.pfn_layers = nn.ModuleList(
            PFNLayer(cin, cout, last_layer=i == len(chans) - 2, norm_cfg=norm_cfg)
            for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])))

    def forward(self, features: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """features [M, P, C] (slots past ``num_points`` zero), num_points
        [M], coords [M, 3] (x, y, z)."""
        M, P, _ = features.shape
        xyz = features[..., :3]
        mean = xyz.sum(1, keepdim=True) / num_points.clamp(min=1).to(features.dtype)[:, None, None]
        parts = [features, xyz - mean,
                 pillar_centre_offsets(features, coords, self.voxel_size, self.point_cloud_range)]
        if self.with_distance:
            parts.append(xyz.norm(dim=-1, keepdim=True))
        pm = point_mask(num_points, P)
        x = torch.where(pm[..., None], torch.cat(parts, -1), 0.0)
        for layer in self.pfn_layers:
            x = layer(x, pm)
        return x[:, 0]


@BACKBONES.register
class PointPillarsScatter(nn.Module):
    """Pillar features [M, C] at coords [M, 3] (x, y, z), mask [M] -> the
    dense canvas [C, X, Y]: cell ``x * Y + y``; masked pillars go to a dump
    row that is dropped."""

    def __init__(self, in_channels: int = 64, output_shape: Sequence[int] = (512, 512)):
        super().__init__()
        self.nx, self.ny = int(output_shape[0]), int(output_shape[1])

    def forward(self, pillar_feats: torch.Tensor, coords: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        cells = self.nx * self.ny
        idx = torch.where(mask, coords[:, 0].long() * self.ny + coords[:, 1], cells)
        canvas = pillar_feats.new_zeros(cells + 1, pillar_feats.shape[-1]).index_copy(
            0, idx, torch.where(mask[:, None], pillar_feats, 0.0))
        return canvas[:-1].t().contiguous().view(-1, self.nx, self.ny)


class PillarBranch(nn.Module):
    """A point-table encoder then the scatter, per sample: voxel table
    [B, M, P, C], coords [B, M, 3], mask [B, M], num_points [B, M] ->
    [B, C', X, Y]."""

    def __init__(self, pts_voxel_encoder: Dict[str, Any], pts_middle_encoder: Dict[str, Any]):
        super().__init__()
        self.pts_voxel_encoder = BACKBONES.build(pts_voxel_encoder)
        self.pts_middle_encoder = BACKBONES.build(pts_middle_encoder)

    def forward(self, voxel_table: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        return torch.stack([
            self.pts_middle_encoder(self.pts_voxel_encoder(t, n, c), c, m)
            for t, c, m, n in zip(voxel_table, coords, mask, num_points)])


@BACKBONES.register
class PointPillarsEncoder(PillarBranch):
    """``PillarFeatureNet`` then ``PointPillarsScatter``, per sample."""
