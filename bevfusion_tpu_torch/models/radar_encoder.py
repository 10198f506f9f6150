"""Radar pillar encoder.

Counterpart of ``bevfusion_tpu/models/radar_encoder.py`` (reference
mmdet3d/models/backbones/radar_encoder.py): ``RFNLayer`` (Linear without
bias, BN1d, ReLU; only the last layer takes the max over the pillar's
points), ``RadarFeatureNet`` (each point decorated to [xyz normalised to
the cloud range (3), the raw channels from 3 on, the offset from the
pillar centre (2)], padded points zeroed, then NaN and inf replaced, as
the reference's CUDA feature decorator does) and ``RadarEncoder`` (the
feature net, ``PointPillarsScatter`` and an optional BEV backbone).

Module names follow the reference checkpoint: ``pts_voxel_encoder.
rfn_layers.{i}.{linear,norm}``, ``pts_middle_encoder``, ``pts_bev_encoder``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..registry import BACKBONES
from .pillar_encoder import (PillarBranch, PointLayer, masked_max, pillar_centre_offsets,
                             point_mask)

__all__ = ["RFNLayer", "RadarFeatureNet", "RadarEncoder"]


class RFNLayer(PointLayer):
    """[M, P, Cin] -> [M, P, Cout] with padded points 0, or, as the last
    layer, the max over the stored points [M, 1, Cout]."""

    def __init__(self, in_channels: int, out_channels: int, last_layer: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__(in_channels, out_channels, norm_cfg)
        self.last_layer = last_layer

    def forward(self, x: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return masked_max(y, pm) if self.last_layer else torch.where(pm[..., None], y, 0.0)


@BACKBONES.register
class RadarFeatureNet(nn.Module):
    """Radar point table [M, P, C] -> pillar features [M, C_out]; the first
    Linear takes ``in_channels + 2`` (xyz normalised in place of xyz, plus
    the two centre offsets)."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False, voxel_size=(0.2, 0.2, 4),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1), norm_cfg: Optional[dict] = None):
        super().__init__()
        if with_distance:
            raise NotImplementedError("RadarFeatureNet: with_distance (the JAX package ignores "
                                      "it; every config sets it false)")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        chans = [in_channels + 2] + list(feat_channels)
        self.rfn_layers = nn.ModuleList(
            RFNLayer(cin, cout, last_layer=i == len(chans) - 2, norm_cfg=norm_cfg)
            for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])))

    def forward(self, features: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """features [M, P, C] (slots past ``num_points`` zero), num_points
        [M], coords [M, 3] (x, y, z)."""
        pcr = self.point_cloud_range
        norm_xyz = torch.stack([(features[..., i] - pcr[i]) / (pcr[i + 3] - pcr[i])
                                for i in range(3)], -1)
        x = torch.cat([norm_xyz, features[..., 3:],
                       pillar_centre_offsets(features, coords, self.voxel_size, pcr)], -1)
        pm = point_mask(num_points, features.shape[1])
        x = torch.where(pm[..., None], x, 0.0).nan_to_num()
        for layer in self.rfn_layers:
            x = layer(x, pm)
        return x[:, 0]


@BACKBONES.register
class RadarEncoder(PillarBranch):
    """``RadarFeatureNet`` then ``PointPillarsScatter`` per sample, then
    ``pts_bev_encoder`` (built through ``BACKBONES``; its first map where it
    returns several) when the config gives one; every config sets it null."""

    def __init__(self, pts_voxel_encoder: Dict[str, Any], pts_middle_encoder: Dict[str, Any],
                 pts_transformer_encoder: Optional[Dict[str, Any]] = None,
                 pts_bev_encoder: Optional[Dict[str, Any]] = None,
                 post_scatter: Optional[Dict[str, Any]] = None):
        super().__init__(pts_voxel_encoder, pts_middle_encoder)
        for key, cfg in (("pts_transformer_encoder", pts_transformer_encoder),
                         ("post_scatter", post_scatter)):
            if cfg is not None:
                raise NotImplementedError(f"RadarEncoder: {key} (the JAX package ignores it; no "
                                          "config sets it)")
        self.pts_bev_encoder = BACKBONES.build(pts_bev_encoder) if pts_bev_encoder else None

    def forward(self, voxel_table: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        x = super().forward(voxel_table, coords, mask, num_points)
        if self.pts_bev_encoder is not None:
            x = self.pts_bev_encoder(x)
            if isinstance(x, (list, tuple)):
                x = x[0]
        return x
