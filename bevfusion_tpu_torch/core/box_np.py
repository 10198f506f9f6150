"""Numpy 3D box / point geometry for the host data pipeline.

A copy of ``bevfusion_tpu/core/box_np.py``, held to it by
tests/test_torch_data.py. Behavioral reference:
mmdet3d/core/bbox/structures/lidar_box3d.py (boxes are [N, 7+]: x, y,
z_bottom, dx(w), dy(l), dz(h), yaw, (vx, vy); LiDAR frame, bottom-center
origin) and core/bbox/box_np_ops.py (corners, points-in-box). The
pipeline runs on the host in numpy; only padded fixed-shape arrays
become tensors (``runtime/eval.py:to_model_batch``).

``points_in_rbbox_libm`` is the port's form of the JAX package's other
points-in-box test, the C++ loop of its native host library
(``bevfusion_tpu/native/csrc/host_ops.cpp:38-54``), which its
``ObjectPaste`` calls.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["LiDARBoxes3D", "rotation_2d", "points_in_rbbox", "points_in_rbbox_libm",
           "corners_bev"]


def rotation_2d(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]], np.float32)


class LiDARBoxes3D:
    """Minimal LiDARInstance3DBoxes equivalent (tensor [N, box_dim]).

    Matches the reference semantics used by the pipeline: rotate also
    rotates velocities, flip negates the right axes, in-range test uses
    gravity-centers-in-BEV (lidar_box3d.py:10-274).
    """

    def __init__(self, tensor: np.ndarray, box_dim: int = 9):
        tensor = np.asarray(tensor, np.float32).reshape(-1, box_dim)
        self.tensor = tensor
        self.box_dim = box_dim

    def __len__(self):
        return self.tensor.shape[0]

    @property
    def gravity_center(self) -> np.ndarray:
        c = self.tensor[:, :3].copy()
        c[:, 2] += self.tensor[:, 5] / 2
        return c

    @property
    def bev(self) -> np.ndarray:
        """[N, 5] = (cx, cy, dx, dy, yaw)."""
        return self.tensor[:, [0, 1, 3, 4, 6]]

    def corners(self) -> np.ndarray:
        """[N, 8, 3] box corners in lidar frame."""
        dims = self.tensor[:, 3:6]
        template = np.array(
            [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (0.0, 1.0)],
            np.float32,
        )
        corners = dims[:, None, :] * template[None]
        yaw = self.tensor[:, 6]
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.stack(
            [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
        )  # [N, 2, 2]
        corners_xy = np.einsum("nij,nkj->nki", rot, corners[..., :2])
        corners = np.concatenate([corners_xy, corners[..., 2:]], -1)
        return corners + self.tensor[:, None, :3]

    def rotate(self, angle: float) -> np.ndarray:
        """Rotate boxes (and return the 2D rotation applied, for point
        co-rotation). Positive angle = counterclockwise around +z."""
        rot = rotation_2d(angle)
        self.tensor[:, :2] = self.tensor[:, :2] @ rot.T
        self.tensor[:, 6] += angle
        if self.box_dim > 7:
            self.tensor[:, 7:9] = self.tensor[:, 7:9] @ rot.T
        return rot

    def translate(self, trans: np.ndarray) -> None:
        self.tensor[:, :3] += np.asarray(trans, np.float32)

    def scale(self, factor: float) -> None:
        self.tensor[:, :6] *= factor
        if self.box_dim > 7:
            self.tensor[:, 7:9] *= factor

    def flip(self, direction: str = "horizontal") -> None:
        """horizontal: flip along y (negate y, yaw); vertical: along x
        (negate x, yaw+pi) — matching lidar_box3d.py flip semantics."""
        if direction == "horizontal":
            self.tensor[:, 1] = -self.tensor[:, 1]
            self.tensor[:, 6] = -self.tensor[:, 6]
            if self.box_dim > 7:
                self.tensor[:, 8] = -self.tensor[:, 8]
        elif direction == "vertical":
            self.tensor[:, 0] = -self.tensor[:, 0]
            self.tensor[:, 6] = -self.tensor[:, 6] + np.pi
            if self.box_dim > 7:
                self.tensor[:, 7] = -self.tensor[:, 7]
        else:
            raise ValueError(direction)

    def in_range_bev(self, pcr: Sequence[float]) -> np.ndarray:
        """Keep boxes whose center is inside the BEV range
        (ObjectRangeFilter uses this, transforms_3d.py:535+)."""
        c = self.tensor
        return (
            (c[:, 0] > pcr[0]) & (c[:, 1] > pcr[1])
            & (c[:, 0] < pcr[3]) & (c[:, 1] < pcr[4])
        )

    def limit_yaw(self, offset: float = 0.5, period: float = np.pi * 2):
        self.tensor[:, 6] = _limit_period(self.tensor[:, 6], offset, period)

    def copy(self) -> "LiDARBoxes3D":
        return LiDARBoxes3D(self.tensor.copy(), self.box_dim)


def _limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def corners_bev(boxes: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, dx, dy, yaw) -> [N, 4, 2] BEV corners."""
    cx, cy, dx, dy, yaw = (boxes[:, i] for i in range(5))
    template = np.array([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]], np.float32)
    pts = template[None] * np.stack([dx, dy], -1)[:, None]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    out = np.einsum("nij,nkj->nki", rot, pts)
    return out + np.stack([cx, cy], -1)[:, None]


def _inside(points: np.ndarray, boxes: np.ndarray, c: np.ndarray, s: np.ndarray) -> np.ndarray:
    d = points[:, None, :3] - boxes[None, :, :3]  # bottom-center origin
    lx = d[..., 0] * c[None] - d[..., 1] * s[None]
    ly = d[..., 0] * s[None] + d[..., 1] * c[None]
    lz = d[..., 2]
    return (
        (np.abs(lx) <= boxes[None, :, 3] / 2)
        & (np.abs(ly) <= boxes[None, :, 4] / 2)
        & (lz >= 0)
        & (lz <= boxes[None, :, 5])
    )


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """[P, >=3] points vs [N, 7] boxes -> [P, N] bool.

    Closed-form point-in-rotated-box test (replaces the reference's
    roiaware_pool3d CUDA points_in_boxes, SURVEY §2.10 item 6)."""
    yaw = boxes[:, 6]
    return _inside(points, boxes, np.cos(-yaw), np.sin(-yaw))


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (lib.cosf, lib.sinf):
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def points_in_rbbox_libm(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """``points_in_rbbox`` as the JAX package's native C++ loop computes it,
    bit for bit: float32 points and boxes, and each box's cos and sin of
    -yaw from the C library's ``cosf`` / ``sinf``, as ``std::cos`` of a
    float calls them. numpy's float32 cos and sin differ from those in the
    last bit for about 15% of angles, which moves a point on a box's face
    across it."""
    points = np.ascontiguousarray(points, np.float32)
    boxes = np.ascontiguousarray(boxes[:, :7], np.float32)
    libm = _libm()
    c = np.array([libm.cosf(-float(y)) for y in boxes[:, 6]], np.float32)
    s = np.array([libm.sinf(-float(y)) for y in boxes[:, 6]], np.float32)
    return _inside(points, boxes, c, s)
