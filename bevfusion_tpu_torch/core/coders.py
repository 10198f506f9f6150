"""Box coders, each registered in ``BBOX_CODERS`` under its JAX name.

Counterparts of ``bevfusion_tpu/core/coders.py``:

- ``TransFusionBBoxCoder``, ``CenterPointBBoxCoder`` (reference
  mmdet3d/core/bbox/coders/transfusion_bbox_coder.py:39-121,
  centerpoint_bbox_coders.py:62-225): feature-grid centers back to metres,
  log dims back to sizes, yaw from (sin, cos); CenterPoint's top-k over the
  class heatmaps and per-pixel gather. The configs' heads decode with them.
- The coders no config names (the JAX module's :183-450):
  ``DeltaXYZWLHRBBoxCoder`` (SECOND-style anchor deltas),
  ``PartialBinBasedBBoxCoder``, ``AnchorFreeBBoxCoder`` and
  ``GroupFree3DBBoxCoder`` (VoteNet-family bin direction coders),
  ``NMSFreeCoder`` with ``normalize_bbox`` / ``denormalize_bbox``
  (DETR3D-style). tests/test_torch_core_inventory.py holds them to the JAX
  ones.

The reference's boolean filtering (score threshold, post-center range) is
a validity mask, so shapes stay fixed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..registry import BBOX_CODERS

__all__ = [
    "TransFusionBBoxCoder", "CenterPointBBoxCoder", "DeltaXYZWLHRBBoxCoder",
    "PartialBinBasedBBoxCoder", "AnchorFreeBBoxCoder", "GroupFree3DBBoxCoder",
    "NMSFreeCoder", "normalize_bbox", "denormalize_bbox",
]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _mask(boxes, scores, score_threshold, post_center_range):
    """The validity mask of the reference's score and post-center filters."""
    mask = torch.ones_like(scores, dtype=torch.bool)
    if score_threshold is not None:
        mask &= scores > score_threshold
    if post_center_range is not None:
        pcr = torch.tensor(post_center_range, dtype=boxes.dtype, device=boxes.device)
        mask &= (boxes[..., :3] >= pcr[:3]).all(-1) & (boxes[..., :3] <= pcr[3:]).all(-1)
    return mask


@BBOX_CODERS.register
class TransFusionBBoxCoder:
    def __init__(self, pc_range, out_size_factor, voxel_size, post_center_range=None,
                 score_threshold=None, code_size=8):
        self.pc_range = tuple(pc_range)
        self.out_size_factor = out_size_factor
        self.voxel_size = tuple(voxel_size)
        self.post_center_range = tuple(post_center_range) if post_center_range else None
        self.score_threshold = score_threshold
        self.code_size = code_size

    def encode(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [N, 7 or 9] (x, y, z bottom, w, l, h, yaw, [vx, vy]) ->
        regression targets [N, code_size]: feature-grid centers, gravity
        center z, log dims, (sin, cos) yaw, velocity
        (transfusion_bbox_coder.py:24-37)."""
        x = (boxes[:, 0] - self.pc_range[0]) / (self.out_size_factor * self.voxel_size[0])
        y = (boxes[:, 1] - self.pc_range[1]) / (self.out_size_factor * self.voxel_size[1])
        z = boxes[:, 2] + boxes[:, 5] * 0.5
        dims = torch.log(torch.clamp(boxes[:, 3:6], min=1e-8))
        cols = [x, y, z, dims[:, 0], dims[:, 1], dims[:, 2], torch.sin(boxes[:, 6]),
                torch.cos(boxes[:, 6])]
        if self.code_size == 10:
            cols += [boxes[:, 7], boxes[:, 8]]
        return torch.stack(cols, -1)

    def decode(self, heatmap, rot, dim, center, height, vel: Optional[torch.Tensor]):
        """heatmap [B, num_cls, P]; rot [B, 2, P]; dim [B, 3, P]; center
        [B, 2, P] (feature-grid units); height [B, 1, P]; vel [B, 2, P] or
        None. Returns {"bboxes" [B, P, 7 or 9], "scores", "labels", "mask"},
        the mask marking boxes that pass the filters."""
        scores, labels = heatmap.max(dim=1)
        cx = center[:, 0] * self.out_size_factor * self.voxel_size[0] + self.pc_range[0]
        cy = center[:, 1] * self.out_size_factor * self.voxel_size[1] + self.pc_range[1]
        d = dim.exp()
        z = height[:, 0] - d[:, 2] * 0.5
        yaw = torch.atan2(rot[:, 0], rot[:, 1])
        parts = [cx, cy, z, d[:, 0], d[:, 1], d[:, 2], yaw]
        if vel is not None:
            parts += [vel[:, 0], vel[:, 1]]
        boxes = torch.stack(parts, -1)
        mask = _mask(boxes, scores, self.score_threshold, self.post_center_range)
        return {"bboxes": boxes, "scores": scores, "labels": labels, "mask": mask}


def _topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    equal values in index order, as ``jax.lax.top_k`` takes them
    (``torch.topk`` promises no order among ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@BBOX_CODERS.register
class CenterPointBBoxCoder:
    def __init__(self, pc_range, out_size_factor, voxel_size, post_center_range=None,
                 max_num=100, score_threshold=None, code_size=9):
        self.pc_range = tuple(pc_range)
        self.out_size_factor = out_size_factor
        self.voxel_size = tuple(voxel_size)
        self.post_center_range = tuple(post_center_range) if post_center_range else None
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.code_size = code_size

    def _topk(self, scores: torch.Tensor):
        """scores [B, C, H, W] -> (score, flat index, class, ys, xs), each
        [B, K]: the top K per class, then the top K of those; the reference's
        ``x = idx // W``, ``y = idx % W`` (centerpoint_bbox_coders.py:62-101)."""
        K = self.max_num
        B, C, H, W = scores.shape
        top_s, top_i = _topk_stable(scores.reshape(B, C, H * W), K)
        xs = (top_i // W).float()
        ys = (top_i % W).float()
        top_s2, top_i2 = _topk_stable(top_s.reshape(B, C * K), K)
        cls = (top_i2 // K).int()

        def gather(a):
            return torch.gather(a.reshape(B, C * K), 1, top_i2)

        return top_s2, gather(top_i), cls, gather(ys), gather(xs)

    def decode(self, heat, rot_sine, rot_cosine, hei, dim, vel=None, reg=None):
        """heat [B, C, H, W] (probabilities); the per-pixel maps [B, c, H, W].
        Returns {"bboxes" [B, K, 7 or 9] (gravity center), "scores",
        "labels", "mask"} (decode :121-225)."""
        B, C, H, W = heat.shape
        scores, inds, clses, ys, xs = self._topk(heat)

        def gather_map(m):  # [B, c, H, W] -> [B, K, c]
            return torch.gather(m.reshape(B, m.shape[1], H * W), 2,
                                inds[:, None, :].expand(-1, m.shape[1], -1)).transpose(1, 2)

        if reg is not None:
            r = gather_map(reg)
            xs = xs[..., None] + r[..., 0:1]
            ys = ys[..., None] + r[..., 1:2]
        else:
            xs = xs[..., None] + 0.5
            ys = ys[..., None] + 0.5
        yaw = torch.atan2(gather_map(rot_sine), gather_map(rot_cosine))
        xs = xs * self.out_size_factor * self.voxel_size[0] + self.pc_range[0]
        ys = ys * self.out_size_factor * self.voxel_size[1] + self.pc_range[1]
        parts = [xs, ys, gather_map(hei), gather_map(dim), yaw]
        if vel is not None:
            parts.append(gather_map(vel))
        boxes = torch.cat(parts, -1)
        mask = _mask(boxes, scores, self.score_threshold, self.post_center_range)
        return {"bboxes": boxes, "scores": scores, "labels": clses, "mask": mask}


@BBOX_CODERS.register
class DeltaXYZWLHRBBoxCoder:
    """SECOND-style anchor-delta coder
    (delta_xyzwhlr_bbox_coder.py:20-88): xy normalized by the anchor BEV
    diagonal, z by anchor height (on gravity centers), log-ratio dims,
    additive yaw; extra dims (velocity) are plain residuals."""

    def __init__(self, code_size: int = 7):
        self.code_size = code_size

    @staticmethod
    def encode(src_boxes, dst_boxes):
        a, g = _t(src_boxes), _t(dst_boxes)
        za = a[..., 2:3] + a[..., 5:6] * 0.5
        zg = g[..., 2:3] + g[..., 5:6] * 0.5
        diag = torch.sqrt(a[..., 3:4] ** 2 + a[..., 4:5] ** 2)
        xt = (g[..., 0:1] - a[..., 0:1]) / diag
        yt = (g[..., 1:2] - a[..., 1:2]) / diag
        zt = (zg - za) / a[..., 5:6]
        wlh = torch.log(g[..., 3:6] / a[..., 3:6])
        rt = g[..., 6:7] - a[..., 6:7]
        extra = g[..., 7:] - a[..., 7:]
        return torch.cat([xt, yt, zt, wlh, rt, extra], -1)

    @staticmethod
    def decode(anchors, deltas):
        a, t = _t(anchors), _t(deltas)
        za = a[..., 2:3] + a[..., 5:6] * 0.5
        diag = torch.sqrt(a[..., 3:4] ** 2 + a[..., 4:5] ** 2)
        xg = t[..., 0:1] * diag + a[..., 0:1]
        yg = t[..., 1:2] * diag + a[..., 1:2]
        zg = t[..., 2:3] * a[..., 5:6] + za
        wlh = torch.exp(t[..., 3:6]) * a[..., 3:6]
        rg = t[..., 6:7] + a[..., 6:7]
        zg = zg - wlh[..., 2:3] * 0.5
        extra = t[..., 7:] + a[..., 7:]
        return torch.cat([xg, yg, zg, wlh, rg, extra], -1)


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, p, idx[b, p]]`` over the third axis (``take_along_axis``)."""
    return torch.gather(x, 2, idx[..., None])[..., 0]


def _pick_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, p, idx[b, p], :]`` of ``x [B, P, S, 3]``."""
    return torch.gather(x, 2, idx[..., None, None].expand(-1, -1, 1, x.shape[-1]))[:, :, 0]


@BBOX_CODERS.register
class PartialBinBasedBBoxCoder:
    """VoteNet partial-bin coder (partial_bin_based_bbox_coder.py:9-232):
    direction encoded as (bin class, residual), size as (class, residual
    vs per-class mean size); decode and split on [B, P, ...] tensors."""

    def __init__(self, num_dir_bins, num_sizes, mean_sizes, with_rot=True):
        assert len(mean_sizes) == num_sizes
        self.num_dir_bins = int(num_dir_bins)
        self.num_sizes = int(num_sizes)
        self.mean_sizes = [list(map(float, m)) for m in mean_sizes]
        self.with_rot = with_rot

    def _means(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.mean_sizes, dtype=torch.float32, device=like.device)

    # --- angle bin helpers (reference :199-243) ---
    def angle2class(self, angle):
        two_pi = 2 * math.pi
        per = two_pi / self.num_dir_bins
        shifted = (angle % two_pi + per / 2) % two_pi
        cls = torch.floor(shifted / per)
        res = shifted - (cls * per + per / 2)
        return cls.to(torch.int32), res

    def class2angle(self, angle_cls, angle_res, limit_period=True):
        per = 2 * math.pi / self.num_dir_bins
        angle = angle_cls.to(torch.float32) * per + angle_res
        if limit_period:
            angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
        return angle

    def _center(self, g: torch.Tensor) -> torch.Tensor:
        """Bottom-center boxes' gravity centers."""
        center = g[:, :3].clone()
        center[:, 2] += g[:, 5] * 0.5
        return center

    def _direction(self, g: torch.Tensor, like: torch.Tensor):
        if self.with_rot:
            return self.angle2class(g[:, 6])
        return torch.zeros_like(like), torch.zeros((g.shape[0],), dtype=g.dtype, device=g.device)

    def encode(self, gt_boxes, gt_labels):
        """gt_boxes [N, 7] (bottom-center) -> center/size-class/size-res/
        dir-class/dir-res targets (reference :27-55)."""
        g = _t(gt_boxes)
        size_cls = _t(gt_labels).to(torch.int32)
        size_res = g[:, 3:6] - self._means(g)[size_cls.long()]
        dir_cls, dir_res = self._direction(g, size_cls)
        return self._center(g), size_cls, size_res, dir_cls, dir_res

    def _dir_angle(self, bbox_out, key_cls, key_res, center):
        B, P = center.shape[:2]
        if not self.with_rot:
            return torch.zeros((B, P, 1), dtype=center.dtype, device=center.device)
        dir_cls = torch.argmax(bbox_out[key_cls], -1)
        return self.class2angle(dir_cls, _pick(bbox_out[key_res], dir_cls))[..., None]

    def decode(self, bbox_out: Dict[str, Any], suffix: str = ""):
        """center [B,P,3] (gravity), dir_class [B,P,Nd] logits, dir_res
        [B,P,Nd], size_class [B,P,Ns] logits, size_res [B,P,Ns,3] ->
        [B, P, 7] (reference :57-96)."""
        center = bbox_out["center" + suffix]
        dir_angle = self._dir_angle(bbox_out, "dir_class" + suffix, "dir_res" + suffix, center)
        size_cls = torch.argmax(bbox_out["size_class" + suffix], -1)
        size = self._means(center)[size_cls] + _pick_rows(bbox_out["size_res" + suffix], size_cls)
        return torch.cat([center, size, dir_angle], -1)

    def split_pred(self, cls_preds, reg_preds, base_xyz):
        """cls_preds [B, C, P], reg_preds [B, R, P], base_xyz [B, P, 3]
        -> dict (reference :139-197)."""
        out: Dict[str, Any] = {}
        reg = reg_preds.transpose(1, 2)
        cls = cls_preds.transpose(1, 2)
        s, nd, ns = 0, self.num_dir_bins, self.num_sizes
        out["center"] = base_xyz + reg[..., s:s + 3]
        s += 3
        out["dir_class"] = reg[..., s:s + nd]
        s += nd
        out["dir_res_norm"] = reg[..., s:s + nd]
        out["dir_res"] = out["dir_res_norm"] * (math.pi / nd)
        s += nd
        out["size_class"] = reg[..., s:s + ns]
        s += ns
        B, P = reg.shape[:2]
        out["size_res_norm"] = reg[..., s:s + ns * 3].reshape(B, P, ns, 3)
        out["size_res"] = out["size_res_norm"] * self._means(reg)[None, None]
        out["obj_scores"] = cls[..., :2]
        out["sem_scores"] = cls[..., 2:]
        return out


@BBOX_CODERS.register
class AnchorFreeBBoxCoder(PartialBinBasedBBoxCoder):
    """Anchor-free variant (anchor_free_bbox_coder.py:9-124): size is a
    direct half-extent regression; direction residual normalized by the
    full bin width."""

    def __init__(self, num_dir_bins, with_rot=True):
        super().__init__(num_dir_bins, 0, [], with_rot=with_rot)

    def encode(self, gt_boxes, gt_labels):
        g = _t(gt_boxes)
        size_res = g[:, 3:6] / 2
        dir_cls, dir_res = self._direction(
            g, torch.zeros((g.shape[0],), dtype=torch.int32, device=g.device))
        if self.with_rot:
            dir_res = dir_res / (2 * math.pi / self.num_dir_bins)
        return self._center(g), size_res, dir_cls, dir_res

    def decode(self, bbox_out: Dict[str, Any]):
        center = bbox_out["center"]
        dir_angle = self._dir_angle(bbox_out, "dir_class", "dir_res", center)
        size = torch.clamp(bbox_out["size"] * 2, min=0.1)
        return torch.cat([center, size, dir_angle], -1)

    def split_pred(self, cls_preds, reg_preds, base_xyz):
        out: Dict[str, Any] = {"obj_scores": cls_preds}
        reg = reg_preds.transpose(1, 2)
        nd = self.num_dir_bins
        out["center_offset"] = reg[..., 0:3]
        out["center"] = base_xyz.detach() + reg[..., 0:3]
        out["size"] = reg[..., 3:6]
        out["dir_class"] = reg[..., 6:6 + nd]
        out["dir_res_norm"] = reg[..., 6 + nd:6 + 2 * nd]
        out["dir_res"] = out["dir_res_norm"] * (2 * math.pi / nd)
        return out


@BBOX_CODERS.register
class GroupFree3DBBoxCoder(PartialBinBasedBBoxCoder):
    """GroupFree3D variant (groupfree3d_bbox_coder.py:9-174): optional
    class-agnostic size head; prefixed prediction keys."""

    def __init__(self, num_dir_bins, num_sizes, mean_sizes, with_rot=True,
                 size_cls_agnostic=True):
        super().__init__(num_dir_bins, num_sizes, mean_sizes, with_rot=with_rot)
        self.size_cls_agnostic = size_cls_agnostic

    def encode(self, gt_boxes, gt_labels):
        center, size_cls, size_res, dir_cls, dir_res = super().encode(gt_boxes, gt_labels)
        return center, _t(gt_boxes)[:, 3:6], size_cls, size_res, dir_cls, dir_res

    def decode(self, bbox_out: Dict[str, Any], prefix: str = ""):
        center = bbox_out[f"{prefix}center"]
        B, P = center.shape[:2]
        dir_angle = self._dir_angle(bbox_out, f"{prefix}dir_class", f"{prefix}dir_res", center)
        if self.size_cls_agnostic:
            size = bbox_out[f"{prefix}size"].reshape(B, P, 3)
        else:
            size_cls = torch.argmax(bbox_out[f"{prefix}size_class"], -1)
            size = self._means(center)[size_cls] + _pick_rows(bbox_out[f"{prefix}size_res"],
                                                              size_cls)
        return torch.cat([center, size, dir_angle], -1)

    def split_pred(self, cls_preds, reg_preds, base_xyz, prefix: str = ""):
        out: Dict[str, Any] = {}
        reg = reg_preds.transpose(1, 2)
        cls = cls_preds.transpose(1, 2)
        s, nd, ns = 0, self.num_dir_bins, self.num_sizes
        out[f"{prefix}center_residual"] = reg[..., s:s + 3]
        out[f"{prefix}center"] = base_xyz + reg[..., s:s + 3]
        s += 3
        out[f"{prefix}dir_class"] = reg[..., s:s + nd]
        s += nd
        out[f"{prefix}dir_res_norm"] = reg[..., s:s + nd]
        out[f"{prefix}dir_res"] = out[f"{prefix}dir_res_norm"] * (math.pi / nd)
        s += nd
        if self.size_cls_agnostic:
            out[f"{prefix}size"] = reg[..., s:s + 3]
        else:
            out[f"{prefix}size_class"] = reg[..., s:s + ns]
            s += ns
            B, P = reg.shape[:2]
            out[f"{prefix}size_res_norm"] = reg[..., s:s + ns * 3].reshape(B, P, ns, 3)
            out[f"{prefix}size_res"] = (out[f"{prefix}size_res_norm"]
                                        * self._means(reg)[None, None])
        out[f"{prefix}obj_scores"] = cls[..., :1]
        out[f"{prefix}sem_scores"] = cls[..., 1:]
        return out


def normalize_bbox(bboxes, pc_range=None):
    """[..., 7 or 9] (x,y,z,w,l,h,yaw,vx,vy) -> (cx,cy,logw,logl,cz,logh,
    sin,cos,vx,vy) (core/bbox/util.py:normalize_bbox)."""
    b = _t(bboxes)
    parts = [b[..., 0:2], torch.log(b[..., 3:5]), b[..., 2:3], torch.log(b[..., 5:6]),
             torch.sin(b[..., 6:7]), torch.cos(b[..., 6:7])]
    if b.shape[-1] > 7:
        parts.append(b[..., 7:9])
    return torch.cat(parts, -1)


def denormalize_bbox(normalized, pc_range=None):
    """Inverse of normalize_bbox (core/bbox/util.py:denormalize_bbox)."""
    n = _t(normalized)
    parts = [n[..., 0:2], n[..., 4:5], torch.exp(n[..., 2:4]), torch.exp(n[..., 5:6]),
             torch.atan2(n[..., 6:7], n[..., 7:8])]
    if n.shape[-1] > 8:
        parts.append(n[..., 8:10])
    return torch.cat(parts, -1)


@BBOX_CODERS.register
class NMSFreeCoder:
    """DETR3D-style NMS-free decode (nms_free_coder.py:9-118): sigmoid
    scores flattened over (query, class), top-max_num selection (ties in
    index order, as ``jax.lax.top_k``), bbox denormalization; filtering
    becomes a validity mask."""

    def __init__(self, pc_range, voxel_size=None, post_center_range=None,
                 max_num=100, score_threshold=None, num_classes=10):
        self.pc_range = tuple(pc_range)
        self.post_center_range = tuple(post_center_range) if post_center_range else None
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.num_classes = num_classes

    def encode(self):  # parity with reference (no-op)
        pass

    def decode_single(self, cls_scores, bbox_preds):
        """cls_scores [Q, num_classes] logits; bbox_preds [Q, 10]
        normalized -> dict of top-max_num boxes + mask."""
        top_s, top_i = _topk_stable(torch.sigmoid(cls_scores).reshape(-1), self.max_num)
        labels = top_i % self.num_classes
        boxes = denormalize_bbox(bbox_preds[top_i // self.num_classes])
        return {"bboxes": boxes, "scores": top_s, "labels": labels,
                "mask": _mask(boxes, top_s, self.score_threshold, self.post_center_range)}

    def decode(self, preds_dicts):
        cls = preds_dicts["all_cls_scores"][-1]
        reg = preds_dicts["all_bbox_preds"][-1]
        return [self.decode_single(cls[i], reg[i]) for i in range(cls.shape[0])]
