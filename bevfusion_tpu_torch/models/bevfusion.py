"""BEVFusion top-level model.

Counterpart of ``bevfusion_tpu/models/bevfusion.py`` (reference
mmdet3d/models/fusion_models/bevfusion.py:25-388): camera branch
(backbone -> neck -> vtransform), LiDAR branch (voxelize -> sparse
encoder, or with ``voxelize_reduce: false`` the unreduced point table ->
a pillar encoder) and radar branch (voxelize to the point table -> the
radar pillar encoder), fused in (camera, lidar, radar) order by the
fuser, then the BEV decoder (backbone + neck) -> the task heads:
``object`` (TransFusion or CenterHead, decoded by ``get_bboxes``) and
``map`` (BEV map segmentation), either or both. The camera's vtransform
(LSS, DepthLSS or BEVDepth's AwareBEVDepth / AwareDBEVDepth) is called
the same way whichever it is, with the LiDAR points, or the radar points
where it sets ``use_points: radar``. Any branch may be absent; with one
branch there is no fuser. A decoder neck that returns one map
(``LSSFPN``) is taken as a list of one, so every head reads the first
map of the list. Submodules carry the reference checkpoint's names
(``encoders.camera.{backbone,neck,vtransform}``,
``encoders.{lidar,radar}.backbone``, ``fuser``, ``decoder.backbone``,
``decoder.neck``, ``heads.{object,map}``). In training mode ``forward``
returns the loss dict: ``loss/<head>/<name>`` scaled by ``loss_scale[head]``,
``stats/object/matched_ious`` (TransFusion) and, where a depth-supervised
vtransform (``AwareBEVDepth``, ``AwareDBEVDepth``) gets the batch's
``depths``, its unscaled ``loss/depth``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..ops.voxelize import Voxelization
from ..registry import BACKBONES, FUSERS, FUSIONMODELS, HEADS, NECKS, VTRANSFORMS
from ..utils.profiler import untimed
from .bevdepth import AwareBEVDepth

HEAD_NAMES = ("object", "map")
POINT_KEYS = {"lidar": "points", "radar": "radar"}  # each point branch's batch key (+ "_mask")


@FUSIONMODELS.register
class BEVFusion(nn.Module):
    def __init__(self, encoders: Dict[str, Any], decoder: Dict[str, Any],
                 heads: Dict[str, Any], fuser: Optional[Dict[str, Any]] = None,
                 loss_scale: Optional[Dict[str, float]] = None):
        super().__init__()
        encoders = {k: v for k, v in (encoders or {}).items() if v is not None}
        heads = {k: v for k, v in (heads or {}).items() if v is not None}
        if not heads or set(heads) - set(HEAD_NAMES):
            raise NotImplementedError(f"BEVFusion: heads {sorted(heads)}; the port runs "
                                      f"{' and '.join(HEAD_NAMES)} heads")
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
        for name, max_voxels in (("lidar", 120000), ("radar", 30000)):
            if name in encoders:
                branch = encoders[name]
                vox = dict(branch["voxelize"])
                setattr(self, f"{name}_voxelize", Voxelization(
                    vox["voxel_size"], vox["point_cloud_range"], vox.get("max_num_points", 10),
                    vox.get("max_voxels", max_voxels),
                    "mean" if branch.get("voxelize_reduce", True) else None))
                self.encoders[name] = nn.ModuleDict(
                    {"backbone": BACKBONES.build(branch["backbone"])})
        if fuser is not None:
            self.fuser = FUSERS.build(fuser)
        self.decoder = nn.ModuleDict({"backbone": BACKBONES.build(decoder["backbone"]),
                                      "neck": NECKS.build(decoder["neck"])})
        self.heads = nn.ModuleDict({k: HEADS.build(v) for k, v in heads.items()})
        self.loss_scale = dict(loss_scale or {})

    def extract_camera_features(self, batch: Dict[str, Any], timed=untimed,
                                aux: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """img [B, N, 3, H, W], the camera matrices under the JAX package's
        key names (``camera2lidar``, ``camera_intrinsics``, ``lidar2image``,
        ``img_aug_matrix``, ``lidar_aug_matrix``), ``pool_lut`` when present,
        and the points of the vtransform's depth (``points``, or ``radar``
        where it sets ``use_points: radar``) -> BEV map [B, C, X, Y]. Given
        ``aux`` and the batch's ``depths`` [B, N, H, W], a depth-supervised
        vtransform puts its loss there as ``loss/depth`` (JAX
        bevfusion.py:116-121)."""
        cam = self.encoders["camera"]
        pts = POINT_KEYS[getattr(cam["vtransform"], "use_points", "lidar")]
        img = batch["img"]
        B, N = img.shape[:2]
        feats = timed("camera/backbone",
                      lambda: cam["backbone"](img.reshape(B * N, *img.shape[2:])))
        feats = timed("camera/neck", lambda: cam["neck"](feats))
        if isinstance(feats, (list, tuple)):
            feats = feats[0]
        feats = feats.view(B, N, *feats.shape[1:])
        vt = cam["vtransform"]
        if aux is None or not isinstance(vt, AwareBEVDepth) or batch.get("depths") is None:
            return timed("camera/vtransform", lambda: vt(
                feats, batch.get(pts), batch.get(f"{pts}_mask"), batch))
        bev, aux["loss/depth"] = timed("camera/vtransform", lambda: vt(
            feats, batch.get(pts), batch.get(f"{pts}_mask"), batch, gt_depths=batch["depths"]))
        return bev

    def extract_point_features(self, name: str, points, points_mask, timed=untimed):
        """The ``lidar`` or ``radar`` branch: points [B, P, C], points_mask
        [B, P] -> BEV map [B, C', X, Y]. A reduced voxelization feeds the
        sparse encoder (stage ``lidar/sparse_encoder``); the unreduced point
        table, its coords, mask and counts feed a pillar encoder (stage
        ``<name>/encoder``)."""
        voxelize = getattr(self, f"{name}_voxelize")
        vox = timed(f"{name}/voxelize",
                    lambda: voxelize(points, points_mask, training=self.training))
        backbone = self.encoders[name]["backbone"]
        if voxelize.reduce is None:
            return timed(f"{name}/encoder", lambda: backbone(vox.feats, vox.coords, vox.mask,
                                                             vox.num_points))
        return timed(f"{name}/sparse_encoder", lambda: backbone(vox.feats, vox.coords, vox.mask))

    def bev_features(self, batch: Dict[str, Any], timed=untimed,
                     aux: Optional[Dict[str, torch.Tensor]] = None) -> List[torch.Tensor]:
        """The decoder's BEV maps for ``batch``, as a list (a neck that returns
        one map gives a list of one). ``timed(name, fn)`` runs each stage
        (the profiling tools pass a timer); ``aux`` takes the depth loss
        (``extract_camera_features``)."""
        features = []
        if "camera" in self.encoders:
            features.append(self.extract_camera_features(batch, timed, aux))
        for name, key in POINT_KEYS.items():
            if name in self.encoders:
                features.append(self.extract_point_features(name, batch[key], batch[f"{key}_mask"],
                                                            timed))
        x = timed("fuser", lambda: self.fuser(features)) if hasattr(self, "fuser") else features[0]
        x = timed("decoder/backbone", lambda: self.decoder["backbone"](x))
        x = timed("decoder/neck", lambda: self.decoder["neck"](x))
        return list(x) if isinstance(x, (list, tuple)) else [x]

    def predict(self, batch: Dict[str, Any], timed=untimed) -> Dict[str, torch.Tensor]:
        """The object head's raw predictions for ``batch``."""
        x = self.bev_features(batch, timed)
        return timed("head/forward", lambda: self.heads["object"](x[0]))

    def forward(self, batch: Dict[str, Any], timed=untimed) -> Dict[str, Any]:
        """Eval: ``boxes`` {"bboxes", "scores", "labels", "mask"} from the
        object head, ``masks_bev`` [B, classes, X, Y] from the map head.
        Training (``batch`` with ``gt_boxes``, ``gt_labels``, ``gt_valid`` for
        the object head, ``gt_masks_bev`` [B, classes, X, Y] for the map
        head, ``depths`` [B, N, H, W] for a depth-supervised vtransform): the
        loss dict of the JAX package's ``BEVFusion.__call__``
        (bevfusion.py:155-205). ``timed(name, fn)`` runs each stage, the
        heads (``head/forward``, ``head/map``) and the decode."""
        out, aux = {}, {}
        x = self.bev_features(batch, timed, aux if self.training else None)
        if not self.training:
            if "object" in self.heads:
                head = self.heads["object"]
                preds = timed("head/forward", lambda: head(x[0]))
                out["boxes"] = timed("head/decode", lambda: head.get_bboxes(preds))
            if "map" in self.heads:
                out["masks_bev"] = timed("head/map", lambda: self.heads["map"](x[0]))
            return out
        if "object" in self.heads:
            head = self.heads["object"]
            losses = head.loss(timed("head/forward", lambda: head(x[0])), batch["gt_boxes"],
                               batch["gt_labels"], batch["gt_valid"])
            scale = self.loss_scale.get("object", 1.0)
            out.update({f"stats/object/{k}" if k == "matched_ious" else f"loss/object/{k}":
                        v if k == "matched_ious" else v * scale for k, v in losses.items()})
        if "map" in self.heads:
            losses = timed("head/map", lambda: self.heads["map"](x[0], batch["gt_masks_bev"]))
            scale = self.loss_scale.get("map", 1.0)
            out.update({f"loss/map/{k}": v * scale for k, v in losses.items()})
        out.update(aux)  # the depth loss, unscaled
        return out
