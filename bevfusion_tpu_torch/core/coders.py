"""TransFusion and CenterPoint box decoding.

Counterparts of ``TransFusionBBoxCoder`` and ``CenterPointBBoxCoder`` in
``bevfusion_tpu/core/coders.py`` (reference
mmdet3d/core/bbox/coders/transfusion_bbox_coder.py:39-121,
centerpoint_bbox_coders.py:62-225): feature-grid centers back to metres,
log dims back to sizes, yaw from (sin, cos); CenterPoint's top-k over the
class heatmaps and per-pixel gather. The reference's boolean filtering
(score threshold, post-center range) is a validity mask, so shapes stay
fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["TransFusionBBoxCoder", "CenterPointBBoxCoder"]


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
        mask = torch.ones_like(scores, dtype=torch.bool)
        if self.score_threshold is not None:
            mask &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = torch.tensor(self.post_center_range, dtype=boxes.dtype, device=boxes.device)
            mask &= (boxes[..., :3] >= pcr[:3]).all(-1) & (boxes[..., :3] <= pcr[3:]).all(-1)
        return {"bboxes": boxes, "scores": scores, "labels": labels, "mask": mask}


def _topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    equal values in index order, as ``jax.lax.top_k`` takes them
    (``torch.topk`` promises no order among ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


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
        mask = torch.ones_like(scores, dtype=torch.bool)
        if self.score_threshold is not None:
            mask &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = torch.tensor(self.post_center_range, dtype=boxes.dtype, device=boxes.device)
            mask &= (boxes[..., :3] >= pcr[:3]).all(-1) & (boxes[..., :3] <= pcr[3:]).all(-1)
        return {"bboxes": boxes, "scores": scores, "labels": clses, "mask": mask}
