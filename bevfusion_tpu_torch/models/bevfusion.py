"""BEVFusion top-level model, eval path.

Counterpart of ``bevfusion_tpu/models/bevfusion.py`` (reference
mmdet3d/models/fusion_models/bevfusion.py:25-388): camera branch
(backbone -> neck -> vtransform) and LiDAR branch (voxelize -> sparse
encoder), fused in (camera, lidar) order by the fuser, then the BEV
decoder (backbone + neck) -> TransFusion head -> ``get_bboxes``. Either
branch may be absent; with one branch there is no fuser. Submodules carry
the reference checkpoint's names (``encoders.camera.{backbone,neck,
vtransform}``, ``encoders.lidar.backbone``, ``fuser``, ``decoder.backbone``,
``decoder.neck``, ``heads.object``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops.voxelize import Voxelization
from ..registry import BACKBONES, FUSERS, FUSIONMODELS, HEADS, NECKS, VTRANSFORMS


@FUSIONMODELS.register
class BEVFusion(nn.Module):
    def __init__(self, encoders: Dict[str, Any], decoder: Dict[str, Any],
                 heads: Dict[str, Any], fuser: Optional[Dict[str, Any]] = None,
                 loss_scale: Optional[Dict[str, float]] = None):
        super().__init__()
        encoders = {k: v for k, v in (encoders or {}).items() if v is not None}
        if "radar" in encoders:
            raise NotImplementedError("the radar branch is not ported yet (ROADMAP Queue 1 "
                                      "item 8: radar_encoder)")
        heads = {k: v for k, v in (heads or {}).items() if v is not None}
        if set(heads) != {"object"}:
            raise NotImplementedError("the port runs the object head only "
                                      "(ROADMAP: remaining heads)")
        self.encoders = nn.ModuleDict()
        if "camera" in encoders:
            cam = encoders["camera"]
            self.encoders["camera"] = nn.ModuleDict({
                "backbone": BACKBONES.build(cam["backbone"]), "neck": NECKS.build(cam["neck"]),
                "vtransform": VTRANSFORMS.build(cam["vtransform"])})
        if "lidar" in encoders:
            lidar = encoders["lidar"]
            vox = dict(lidar["voxelize"])
            if not lidar.get("voxelize_reduce", True):
                raise NotImplementedError("pillar (unreduced) voxelization is not ported yet")
            self.lidar_voxelize = Voxelization(vox["voxel_size"], vox["point_cloud_range"],
                                               vox.get("max_num_points", 10),
                                               vox.get("max_voxels", 120000))
            self.encoders["lidar"] = nn.ModuleDict({"backbone": BACKBONES.build(lidar["backbone"])})
        if fuser is not None:
            self.fuser = FUSERS.build(fuser)
        elif len(self.encoders) != 1:
            raise ValueError("BEVFusion: several sensor branches need a fuser")
        self.decoder = nn.ModuleDict({"backbone": BACKBONES.build(decoder["backbone"]),
                                      "neck": NECKS.build(decoder["neck"])})
        self.heads = nn.ModuleDict({"object": HEADS.build(heads["object"])})

    def extract_camera_features(self, batch: Dict[str, Any]) -> torch.Tensor:
        """img [B, N, 3, H, W], the camera matrices under the JAX package's
        key names (``camera2lidar``, ``camera_intrinsics``, ``lidar2image``,
        ``img_aug_matrix``, ``lidar_aug_matrix``), ``pool_lut`` when present,
        and the points for the sparse depth -> BEV map [B, C, X, Y]."""
        cam = self.encoders["camera"]
        img = batch["img"]
        B, N = img.shape[:2]
        feats = cam["neck"](cam["backbone"](img.reshape(B * N, *img.shape[2:])))
        if isinstance(feats, (list, tuple)):
            feats = feats[0]
        feats = feats.view(B, N, *feats.shape[1:])
        return cam["vtransform"](feats, batch["points"], batch["points_mask"], batch)

    def extract_lidar_features(self, points, points_mask):
        """points [B, P, C], points_mask [B, P] -> BEV map [B, C', X, Y]."""
        vox = self.lidar_voxelize(points, points_mask, training=self.training)
        return self.encoders["lidar"]["backbone"](vox.feats, vox.coords, vox.mask)

    def predict(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The object head's raw predictions for ``batch``."""
        features = []
        if "camera" in self.encoders:
            features.append(self.extract_camera_features(batch))
        if "lidar" in self.encoders:
            features.append(self.extract_lidar_features(batch["points"], batch["points_mask"]))
        x = self.fuser(features) if hasattr(self, "fuser") else features[0]
        x = self.decoder["neck"](self.decoder["backbone"](x))
        return self.heads["object"](x[0])

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Eval forward: {"boxes": {"bboxes", "scores", "labels", "mask"}}."""
        if self.training:
            raise NotImplementedError("the port runs eval only (ROADMAP: training)")
        return {"boxes": self.heads["object"].get_bboxes(self.predict(batch))}
