"""TransFusion box decoding.

Counterpart of ``TransFusionBBoxCoder.decode`` in
``bevfusion_tpu/core/coders.py`` (reference
mmdet3d/core/bbox/coders/transfusion_bbox_coder.py:39-121): feature-grid
centers back to metres, log dims back to sizes, gravity center back to
bottom center, yaw from (sin, cos). The reference's boolean filtering
(score threshold, post-center range) is a validity mask, so shapes stay
fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["TransFusionBBoxCoder"]


class TransFusionBBoxCoder:
    def __init__(self, pc_range, out_size_factor, voxel_size, post_center_range=None,
                 score_threshold=None, code_size=8):
        self.pc_range = tuple(pc_range)
        self.out_size_factor = out_size_factor
        self.voxel_size = tuple(voxel_size)
        self.post_center_range = tuple(post_center_range) if post_center_range else None
        self.score_threshold = score_threshold
        self.code_size = code_size

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
