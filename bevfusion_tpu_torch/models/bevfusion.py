"""BEVFusion top-level model.

Counterpart of ``bevfusion_tpu/models/bevfusion.py`` (reference
mmdet3d/models/fusion_models/bevfusion.py:25-388): camera branch
(backbone -> neck -> vtransform) and LiDAR branch (voxelize -> sparse
encoder), fused in (camera, lidar) order by the fuser, then the BEV
decoder (backbone + neck) -> TransFusion head -> ``get_bboxes``. Either
branch may be absent; with one branch there is no fuser. Submodules carry
the reference checkpoint's names (``encoders.camera.{backbone,neck,
vtransform}``, ``encoders.lidar.backbone``, ``fuser``, ``decoder.backbone``,
``decoder.neck``, ``heads.object``). In training mode ``forward``
returns the loss dict: ``loss/object/<name>`` scaled by ``loss_scale``
and ``stats/object/matched_ious``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..ops.voxelize import Voxelization
from ..registry import BACKBONES, FUSERS, FUSIONMODELS, HEADS, NECKS, VTRANSFORMS
from ..utils.profiler import untimed


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
        if not encoders:
            raise ValueError("BEVFusion: the config has no sensor branch (every entry of "
                             "model.encoders is null)")
        if fuser is None and len(encoders) > 1:
            raise ValueError("BEVFusion: several sensor branches need a fuser")
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
        self.decoder = nn.ModuleDict({"backbone": BACKBONES.build(decoder["backbone"]),
                                      "neck": NECKS.build(decoder["neck"])})
        self.heads = nn.ModuleDict({"object": HEADS.build(heads["object"])})
        self.loss_scale = dict(loss_scale or {})

    def extract_camera_features(self, batch: Dict[str, Any], timed=untimed) -> torch.Tensor:
        """img [B, N, 3, H, W], the camera matrices under the JAX package's
        key names (``camera2lidar``, ``camera_intrinsics``, ``lidar2image``,
        ``img_aug_matrix``, ``lidar_aug_matrix``), ``pool_lut`` when present,
        and the points for the sparse depth -> BEV map [B, C, X, Y]."""
        cam = self.encoders["camera"]
        img = batch["img"]
        B, N = img.shape[:2]
        feats = timed("camera/backbone",
                      lambda: cam["backbone"](img.reshape(B * N, *img.shape[2:])))
        feats = timed("camera/neck", lambda: cam["neck"](feats))
        if isinstance(feats, (list, tuple)):
            feats = feats[0]
        feats = feats.view(B, N, *feats.shape[1:])
        return timed("camera/vtransform", lambda: cam["vtransform"](
            feats, batch["points"], batch["points_mask"], batch))

    def extract_lidar_features(self, points, points_mask, timed=untimed):
        """points [B, P, C], points_mask [B, P] -> BEV map [B, C', X, Y]."""
        vox = timed("lidar/voxelize",
                    lambda: self.lidar_voxelize(points, points_mask, training=self.training))
        return timed("lidar/sparse_encoder", lambda: self.encoders["lidar"]["backbone"](
            vox.feats, vox.coords, vox.mask))

    def predict(self, batch: Dict[str, Any], timed=untimed) -> Dict[str, torch.Tensor]:
        """The object head's raw predictions for ``batch``. ``timed(name,
        fn)`` runs each stage (the profiling tools pass a timer)."""
        features = []
        if "camera" in self.encoders:
            features.append(self.extract_camera_features(batch, timed))
        if "lidar" in self.encoders:
            features.append(self.extract_lidar_features(batch["points"], batch["points_mask"],
                                                        timed))
        x = timed("fuser", lambda: self.fuser(features)) if hasattr(self, "fuser") else features[0]
        x = timed("decoder/backbone", lambda: self.decoder["backbone"](x))
        x = timed("decoder/neck", lambda: self.decoder["neck"](x))
        return timed("head/forward", lambda: self.heads["object"](x[0]))

    def forward(self, batch: Dict[str, Any], timed=untimed) -> Dict[str, Any]:
        """Eval: {"boxes": {"bboxes", "scores", "labels", "mask"}}. Training
        (``batch`` with ``gt_boxes``, ``gt_labels``, ``gt_valid``): the loss
        dict of the JAX package's ``BEVFusion.__call__`` (bevfusion.py:185-205).
        ``timed(name, fn)`` runs each stage (``predict``) and the decode."""
        head = self.heads["object"]
        if not self.training:
            preds = self.predict(batch, timed)
            return {"boxes": timed("head/decode", lambda: head.get_bboxes(preds))}
        scale = self.loss_scale.get("object", 1.0)
        losses = head.loss(self.predict(batch, timed), batch["gt_boxes"], batch["gt_labels"],
                           batch["gt_valid"])
        return {f"stats/object/{k}" if k == "matched_ious" else f"loss/object/{k}":
                v if k == "matched_ious" else v * scale for k, v in losses.items()}
