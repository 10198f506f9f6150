"""Box coordinate modes + conversions (numpy, host-side).

A copy of ``bevfusion_tpu/core/box_modes.py``, held to it bit for bit by
tests/test_torch_core_inventory.py.

Behavioral reference: mmdet3d/core/bbox/structures/box_3d_mode.py and
coord_3d_mode.py (pre-coordinate-refactor conventions):
  LIDAR: x forward, y left, z up; boxes (x, y, z_bottom, w, l, h, yaw)
  CAM:   x right, y down, z forward; boxes (x, y, z, w, h, l? ...) —
         converted via the fixed permutation matrices below
  DEPTH: x right, y forward, z up
"""
from __future__ import annotations

from enum import IntEnum
from typing import Optional

import numpy as np

__all__ = ["Box3DMode", "convert_boxes", "convert_points"]


class Box3DMode(IntEnum):
    LIDAR = 0
    CAM = 1
    DEPTH = 2


# rotation part of the fixed frame changes (box_3d_mode.py conventions)
_R = {
    (Box3DMode.LIDAR, Box3DMode.CAM): np.array(
        [[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32
    ),
    (Box3DMode.CAM, Box3DMode.LIDAR): np.array(
        [[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32
    ),
    (Box3DMode.LIDAR, Box3DMode.DEPTH): np.array(
        [[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32
    ),
    (Box3DMode.DEPTH, Box3DMode.LIDAR): np.array(
        [[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32
    ),
    (Box3DMode.CAM, Box3DMode.DEPTH): np.array(
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32
    ),
    (Box3DMode.DEPTH, Box3DMode.CAM): np.array(
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32
    ),
}

# (w, l, h) dim permutation per conversion: LIDAR dims (dx, dy, dz);
# CAM swaps the vertical axis into dim order (box_3d_mode.py:to)
_DIM_PERM = {
    (Box3DMode.LIDAR, Box3DMode.CAM): [0, 2, 1],
    (Box3DMode.CAM, Box3DMode.LIDAR): [0, 2, 1],
    (Box3DMode.LIDAR, Box3DMode.DEPTH): [1, 0, 2],
    (Box3DMode.DEPTH, Box3DMode.LIDAR): [1, 0, 2],
    (Box3DMode.CAM, Box3DMode.DEPTH): [0, 2, 1],
    (Box3DMode.DEPTH, Box3DMode.CAM): [0, 2, 1],
}


def convert_points(points: np.ndarray, src: Box3DMode, dst: Box3DMode,
                   rt_mat: Optional[np.ndarray] = None) -> np.ndarray:
    """Convert xyz columns between frames; extra columns pass through."""
    if src == dst:
        return points
    R = rt_mat[:3, :3] if rt_mat is not None else _R[(src, dst)]
    t = rt_mat[:3, 3] if rt_mat is not None and rt_mat.shape == (4, 4) else 0
    out = points.copy()
    out[:, :3] = points[:, :3] @ R.T + t
    return out


def convert_boxes(boxes: np.ndarray, src: Box3DMode, dst: Box3DMode,
                  rt_mat: Optional[np.ndarray] = None) -> np.ndarray:
    """Convert [N, 7+] boxes between modes; yaw flips sign between the
    up-axis conventions (box_3d_mode.py convert)."""
    if src == dst:
        return boxes
    out = boxes.copy()
    R = rt_mat[:3, :3] if rt_mat is not None else _R[(src, dst)]
    t = rt_mat[:3, 3] if rt_mat is not None and rt_mat.shape == (4, 4) else 0
    out[:, :3] = boxes[:, :3] @ R.T + t
    out[:, 3:6] = boxes[:, 3:6][:, _DIM_PERM[(src, dst)]]
    out[:, 6] = -boxes[:, 6] - np.pi / 2 if (
        (src, dst) in ((Box3DMode.LIDAR, Box3DMode.CAM),
                       (Box3DMode.CAM, Box3DMode.LIDAR))
    ) else -boxes[:, 6]
    return out
