"""BEVFusion top-level model, LiDAR-only eval path.

Counterpart of ``bevfusion_tpu/models/bevfusion.py`` (reference
mmdet3d/models/fusion_models/bevfusion.py:25-388): voxelize -> sparse
encoder -> BEV decoder (backbone + neck) -> TransFusion head ->
``get_bboxes``. Submodules carry the reference checkpoint's names
(``encoders.lidar.backbone``, ``decoder.backbone``, ``decoder.neck``,
``heads.object``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops.voxelize import Voxelization
from ..registry import BACKBONES, FUSIONMODELS, HEADS, NECKS


@FUSIONMODELS.register
class BEVFusion(nn.Module):
    def __init__(self, encoders: Dict[str, Any], decoder: Dict[str, Any],
                 heads: Dict[str, Any], fuser: Optional[Dict[str, Any]] = None,
                 loss_scale: Optional[Dict[str, float]] = None):
        super().__init__()
        encoders = encoders or {}
        for name in ("camera", "radar"):
            if encoders.get(name) is not None:
                raise NotImplementedError(
                    f"the {name} branch is not ported yet (ROADMAP Queue 1 item 4: "
                    "camera branch with the BEV-pool kernel)")
        if fuser is not None:
            raise NotImplementedError("fusers are not ported yet (ROADMAP Queue 1 item 4)")
        heads = {k: v for k, v in (heads or {}).items() if v is not None}
        if set(heads) != {"object"}:
            raise NotImplementedError("the port runs the object head only "
                                      "(ROADMAP: remaining heads)")
        lidar = encoders["lidar"]
        vox = dict(lidar["voxelize"])
        if not lidar.get("voxelize_reduce", True):
            raise NotImplementedError("pillar (unreduced) voxelization is not ported yet")
        self.lidar_voxelize = Voxelization(vox["voxel_size"], vox["point_cloud_range"],
                                           vox.get("max_num_points", 10),
                                           vox.get("max_voxels", 120000))
        self.encoders = nn.ModuleDict(
            {"lidar": nn.ModuleDict({"backbone": BACKBONES.build(lidar["backbone"])})})
        self.decoder = nn.ModuleDict({"backbone": BACKBONES.build(decoder["backbone"]),
                                      "neck": NECKS.build(decoder["neck"])})
        self.heads = nn.ModuleDict({"object": HEADS.build(heads["object"])})

    def extract_lidar_features(self, points, points_mask):
        """points [B, P, C], points_mask [B, P] -> BEV map [B, C', X, Y]."""
        vox = self.lidar_voxelize(points, points_mask, training=self.training)
        return self.encoders["lidar"]["backbone"](vox.feats, vox.coords, vox.mask)

    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The object head's raw predictions for ``batch`` (points,
        points_mask)."""
        x = self.extract_lidar_features(batch["points"], batch["points_mask"])
        x = self.decoder["neck"](self.decoder["backbone"](x))
        return self.heads["object"](x[0])

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Eval forward: {"boxes": {"bboxes", "scores", "labels", "mask"}}."""
        if self.training:
            raise NotImplementedError("the port runs eval only (ROADMAP: training)")
        return {"boxes": self.heads["object"].get_bboxes(self.predict(batch))}
