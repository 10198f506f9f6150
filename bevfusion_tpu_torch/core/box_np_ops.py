"""Numpy box-geometry library (host-side, fully vectorized).

A copy of ``bevfusion_tpu/core/box_np_ops.py`` on the port's
``core/box_np.py``, held to it bit for bit by
tests/test_torch_core_inventory.py.

Breadth counterpart of the reference's core/bbox/box_np_ops.py (892 LoC,
numba-jitted loops): corner generation, axis rotations, KITTI camera
projections, frustum culling, convex-polygon containment. Used by data
converters, the GT-database sampler, and offline tooling. Everything
here is plain vectorized numpy — the numba inner loops of the reference
(corner_to_standup_nd_jit, points_in_convex_polygon_3d_jit, iou_jit)
become broadcasted array expressions with identical results.

The BEVFusion hot-path subset (LiDARBoxes3D, points_in_rbbox in lidar
convention) lives in core/box_np.py; this module re-exports it and adds
the long tail.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .box_np import (  # noqa: F401  (re-export the hot-path subset)
    LiDARBoxes3D, _limit_period, corners_bev,
)
from .box_np import points_in_rbbox as points_in_rbbox_lidar  # noqa: F401

__all__ = [
    "corners_nd", "rotation_2d_points", "rotation_3d_in_axis",
    "rotation_points_single_angle", "center_to_corner_box2d",
    "center_to_corner_box3d", "corner_to_standup_nd",
    "corner_to_surfaces_3d", "surface_equ_3d",
    "points_in_convex_polygon_3d", "points_in_convex_polygon",
    "points_cam2img", "camera_to_lidar", "lidar_to_camera",
    "box_camera_to_lidar", "box3d_to_bbox", "points_in_rbbox",
    "minmax_to_corner_2d", "center_to_minmax_2d", "limit_period",
    "rbbox2d_to_near_bbox", "iou_2d", "projection_matrix_to_CRT_kitti",
    "get_frustum", "remove_outside_points", "depth_to_points",
    "depth_to_lidar_points", "boxes3d_to_corners3d_lidar",
]


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap `val` into [-offset*period, (1-offset)*period)
    (box_np_ops.py:469-482)."""
    return val - np.floor(val / period + offset) * period


# ---------------------------------------------------------------------------
# Corner generation & rotations
# ---------------------------------------------------------------------------

# The reference orders 2**ndim corners so consecutive quadruples trace each
# face consistently (box_np_ops.py:48-78): binary counting reordered to
# [0,1,3,2] (2D) / [0,1,3,2,4,5,7,6] (3D).
_REORDER = {2: (0, 1, 3, 2), 3: (0, 1, 3, 2, 4, 5, 7, 6)}


def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """[N, ndim] per-dim lengths -> [N, 2**ndim, ndim] relative corners,
    offset so `origin` (fraction of each dim) sits at zero."""
    dims = np.asarray(dims)
    ndim = dims.shape[1]
    # binary counting: corner k has bit b of axis a = (k >> (ndim-1-a)) & 1
    idx = np.arange(2 ** ndim)
    bits = (idx[:, None] >> np.arange(ndim - 1, -1, -1)[None]) & 1
    unit = bits[list(_REORDER.get(ndim, idx))].astype(dims.dtype)
    unit = unit - np.asarray(origin, dims.dtype)
    return dims[:, None, :] * unit[None]


def rotation_2d_points(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate [N, K, 2] point sets by per-box angles [N] (clockwise for
    positive angle, matching box_np_ops.py:81-96)."""
    c, s = np.cos(angles), np.sin(angles)
    # x' = x*c + y*s ; y' = -x*s + y*c  (row-vector times [[c,-s],[s,c]]^T
    # per the reference's einsum convention)
    x, y = points[..., 0], points[..., 1]
    return np.stack([x * c[:, None] + y * s[:, None],
                     -x * s[:, None] + y * c[:, None]], axis=-1)


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray,
                        axis: int = 0) -> np.ndarray:
    """Rotate [N, K, 3] point sets by per-box angles [N] about `axis`
    (box_np_ops.py:178-211 conventions)."""
    c, s = np.cos(angles), np.sin(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif axis in (2, -1):
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    elif axis == 0:
        rows = [[zero, c, -s], [zero, s, c], [one, zero, zero]]
    else:
        raise ValueError(f"axis {axis}")
    # rows[j][m] = rot_mat_T[j, m] per box; the reference applies
    # einsum('aij,jka->aik', points, rot_mat_T)
    rot_t = np.stack([np.stack(r, -1) for r in rows], -2)  # [N, j, m]
    return np.einsum("akj,ajm->akm", points, rot_t)


def rotation_points_single_angle(points: np.ndarray, angle: float,
                                 axis: int = 0) -> np.ndarray:
    """Rotate [N, 3] points by one angle (box_np_ops.py:315-345)."""
    out = rotation_3d_in_axis(points[None], np.asarray([angle]), axis)
    return out[0]


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """[N,2]x[N,2](x[N]) -> [N, 4, 2] corners (box_np_ops.py:98-123)."""
    corners = corners_nd(np.asarray(dims), origin=origin)
    if angles is not None:
        corners = rotation_2d_points(corners, np.asarray(angles))
    return corners + np.asarray(centers)[:, None, :]


def center_to_corner_box3d(centers, dims, angles=None,
                           origin=(0.5, 1.0, 0.5), axis: int = 1):
    """[N,3]x[N,3](x[N]) -> [N, 8, 3] corners; origin (0.5,1.0,0.5)/axis 1
    for camera, (0.5,0.5,0)/axis 2 for lidar (box_np_ops.py:212-238)."""
    corners = corners_nd(np.asarray(dims), origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, np.asarray(angles), axis=axis)
    return corners + np.asarray(centers).reshape(-1, 1, 3)


def corner_to_standup_nd(boxes_corner: np.ndarray) -> np.ndarray:
    """[N, 2**d, d] corners -> [N, 2d] (mins, maxes)
    (box_np_ops.py:271-290, vectorized)."""
    return np.concatenate(
        [boxes_corner.min(axis=1), boxes_corner.max(axis=1)], axis=-1)


# Face -> corner-index table (normals point inward for corner ordering
# produced by center_to_corner_box3d; box_np_ops.py:292-313).
_SURFACE_IDX = np.array([
    [0, 1, 2, 3], [7, 6, 5, 4], [0, 3, 7, 4],
    [1, 5, 6, 2], [0, 4, 5, 1], [3, 2, 6, 7],
])


def corner_to_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """[N, 8, 3] -> [N, 6, 4, 3] face quads, inward normals."""
    return corners[:, _SURFACE_IDX]


def surface_equ_3d(polygon_surfaces: np.ndarray):
    """[P, S, >=3, 3] surfaces -> (normals [P,S,3], d [P,S]) of
    ax+by+cz+d=0 per face (box_np_ops.py:692-713)."""
    sv = polygon_surfaces[:, :, :2, :] - polygon_surfaces[:, :, 1:3, :]
    normal = np.cross(sv[:, :, 0], sv[:, :, 1])
    d = -np.einsum("psk,psk->ps", normal, polygon_surfaces[:, :, 0, :])
    return normal, d


def points_in_convex_polygon_3d(points: np.ndarray,
                                polygon_surfaces: np.ndarray,
                                num_surfaces: Optional[np.ndarray] = None
                                ) -> np.ndarray:
    """[Q, 3] points vs [P, S, >=3, 3] polyhedra -> [Q, P] bool
    (vectorized form of box_np_ops.py:716-778: inside iff signed distance
    to every (valid) face is negative)."""
    P, S = polygon_surfaces.shape[:2]
    normal, d = surface_equ_3d(polygon_surfaces[:, :, :3, :])
    sign = (np.einsum("qk,psk->qps", points[:, :3], normal)
            + d[None])  # [Q, P, S]
    if num_surfaces is not None:
        # reference loop breaks when k > num_surfaces[j]: faces with index
        # strictly greater than num_surfaces are ignored
        valid = np.arange(S)[None] <= num_surfaces[:, None]
        sign = np.where(valid[None], sign, -1.0)
    return np.all(sign < 0, axis=-1)


def points_in_convex_polygon(points: np.ndarray, polygon: np.ndarray,
                             clockwise: bool = True) -> np.ndarray:
    """[Q, 2] points vs [P, K, 2] convex 2D polygons -> [Q, P] bool
    (box_np_ops.py:781-824: all edge cross-products strictly negative)."""
    prev = np.roll(polygon, 1, axis=1)
    vec = polygon - prev if clockwise else prev - polygon  # [P, K, 2]
    rel_x = polygon[None, :, :, 0] - points[:, None, None, 0]
    rel_y = polygon[None, :, :, 1] - points[:, None, None, 1]
    cross = vec[None, :, :, 1] * rel_x - vec[None, :, :, 0] * rel_y
    return np.all(cross < 0, axis=-1)


# ---------------------------------------------------------------------------
# Camera geometry (KITTI-style)
# ---------------------------------------------------------------------------

def _to_hom(points: np.ndarray) -> np.ndarray:
    if points.shape[-1] == 3:
        ones = np.ones(points.shape[:-1] + (1,), points.dtype)
        return np.concatenate([points, ones], axis=-1)
    return points


def points_cam2img(points_3d: np.ndarray, proj_mat: np.ndarray,
                   with_depth: bool = False) -> np.ndarray:
    """Project camera-frame points to pixels via a 3x3/3x4/4x4 matrix
    (box_np_ops.py:347-384)."""
    proj = np.asarray(proj_mat)
    if proj.shape == (3, 3) or proj.shape == (3, 4):
        full = np.eye(4, dtype=proj.dtype)
        full[:proj.shape[0], :proj.shape[1]] = proj
        proj = full
    p = _to_hom(np.asarray(points_3d)) @ proj.T
    uv = p[..., :2] / p[..., 2:3]
    if with_depth:
        return np.concatenate([uv, p[..., 2:3]], axis=-1)
    return uv


def camera_to_lidar(points, r_rect, velo2cam):
    """CAM -> LiDAR frame: x_l = x_c @ inv(r_rect @ velo2cam)^T
    (box_np_ops.py:8-26)."""
    hom = _to_hom(np.asarray(points))
    return (hom @ np.linalg.inv((r_rect @ velo2cam).T))[..., :3]


def lidar_to_camera(points, r_rect, velo2cam):
    """Inverse of camera_to_lidar."""
    hom = _to_hom(np.asarray(points))
    return (hom @ (r_rect @ velo2cam).T)[..., :3]


def box_camera_to_lidar(data, r_rect, velo2cam):
    """[N, 7] camera boxes (x,y,z,l,h,w,ry) -> lidar boxes (x,y,z,w,l,h,r)
    (box_np_ops.py:28-45)."""
    xyz = camera_to_lidar(data[:, :3], r_rect, velo2cam)
    l, h, w = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    return np.concatenate([xyz, w, l, h, data[:, 6:7]], axis=1)


def box3d_to_bbox(box3d: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """[N, 7] camera boxes -> [N, 4] image-plane minmax bboxes
    (box_np_ops.py:385-404)."""
    corners = center_to_corner_box3d(
        box3d[:, :3], box3d[:, 3:6], box3d[:, 6], (0.5, 1.0, 0.5), axis=1)
    uv = points_cam2img(corners, P2)  # [N, 8, 2]
    return np.concatenate([uv.min(axis=1), uv.max(axis=1)], axis=1)


def points_in_rbbox(points, rbbox, z_axis: int = 2,
                    origin=(0.5, 0.5, 0)) -> np.ndarray:
    """[Q, >=3] points vs [N, 7] rotated boxes -> [Q, N] bool via the
    convex-polyhedron test (box_np_ops.py:430-452)."""
    corners = center_to_corner_box3d(
        rbbox[:, :3], rbbox[:, 3:6], rbbox[:, 6], origin=origin, axis=z_axis)
    return points_in_convex_polygon_3d(
        np.asarray(points)[:, :3], corner_to_surfaces_3d(corners))


# ---------------------------------------------------------------------------
# 2D box utilities
# ---------------------------------------------------------------------------

def center_to_minmax_2d(centers, dims, origin=0.5):
    """[N,2]x[N,2] -> [N,4] (xmin,ymin,xmax,ymax) axis-aligned
    (box_np_ops.py:533-549, no-rotation fast path)."""
    centers, dims = np.asarray(centers), np.asarray(dims)
    org = np.asarray(origin, dims.dtype)
    lo = centers - dims * org
    hi = lo + dims
    return np.concatenate([lo, hi], axis=-1)


def minmax_to_corner_2d(minmax_box: np.ndarray) -> np.ndarray:
    """[N, 2d] minmax -> [N, 4, 2] corners (box_np_ops.py:454-466)."""
    nd = minmax_box.shape[-1] // 2
    lo = minmax_box[..., :nd]
    return center_to_corner_box2d(lo, minmax_box[..., nd:] - lo, origin=0.0)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """[N, 5] (x,y,dx,dy,rad) -> nearest axis-aligned [N, 4] minmax box:
    swap extents when yaw is nearer 90 deg (box_np_ops.py:551-568)."""
    rot = np.abs(limit_period(rbboxes[..., -1], 0.5, np.pi))
    swap = (rot > np.pi / 4)[..., None]
    cd = np.where(swap, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(cd[:, :2], cd[:, 2:])


def iou_2d(boxes: np.ndarray, query_boxes: np.ndarray, mode: str = "iou",
           eps: float = 0.0) -> np.ndarray:
    """Axis-aligned [N,4]x[K,4] IoU/IoF (vectorized box_np_ops.py:571-607)."""
    b, q = np.asarray(boxes), np.asarray(query_boxes)
    iw = (np.minimum(b[:, None, 2], q[None, :, 2])
          - np.maximum(b[:, None, 0], q[None, :, 0]) + eps)
    ih = (np.minimum(b[:, None, 3], q[None, :, 3])
          - np.maximum(b[:, None, 1], q[None, :, 1]) + eps)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = (b[:, 2] - b[:, 0] + eps) * (b[:, 3] - b[:, 1] + eps)
    if mode == "iou":
        area_q = (q[:, 2] - q[:, 0] + eps) * (q[:, 3] - q[:, 1] + eps)
        union = area_b[:, None] + area_q[None] - inter
    else:  # iof
        union = np.broadcast_to(area_b[:, None], inter.shape)
    return np.where(inter > 0, inter / union, 0.0)


# ---------------------------------------------------------------------------
# Frustum culling (offline KITTI tooling)
# ---------------------------------------------------------------------------

def projection_matrix_to_CRT_kitti(proj: np.ndarray):
    """Split P = C @ [R|T] with upper-triangular C via QR on inv(CR)
    (box_np_ops.py:609-631)."""
    CR, CT = proj[:3, :3], proj[:3, 3]
    Rinv, Cinv = np.linalg.qr(np.linalg.inv(CR))
    C = np.linalg.inv(Cinv)
    R = np.linalg.inv(Rinv)
    return C, R, Cinv @ CT


def get_frustum(bbox_image: Sequence[float], C: np.ndarray,
                near_clip: float = 0.001, far_clip: float = 100.0):
    """Image bbox + intrinsics -> [8, 3] frustum corners in camera frame
    (box_np_ops.py:661-690)."""
    fku, fkv = C[0, 0], -C[1, 1]
    u0v0 = C[:2, 2]
    x0, y0, x1, y1 = bbox_image
    uv = np.array([[x0, y0], [x0, y1], [x1, y1], [x1, y0]], C.dtype)
    z = np.array([near_clip] * 4 + [far_clip] * 4, C.dtype)[:, None]
    near = (uv - u0v0) / np.array([fku / near_clip, -fkv / near_clip], C.dtype)
    far = (uv - u0v0) / np.array([fku / far_clip, -fkv / far_clip], C.dtype)
    return np.concatenate([np.concatenate([near, far], 0), z], axis=1)


def remove_outside_points(points, rect, Trv2c, P2, image_shape):
    """Drop lidar points outside the camera frustum
    (box_np_ops.py:633-658)."""
    C, R, T = projection_matrix_to_CRT_kitti(P2)
    frustum = get_frustum([0, 0, image_shape[1], image_shape[0]], C) - T
    frustum = (np.linalg.inv(R) @ frustum.T).T
    frustum = camera_to_lidar(frustum, rect, Trv2c)
    keep = points_in_convex_polygon_3d(
        points[:, :3], corner_to_surfaces_3d(frustum[None]))
    return points[keep.reshape(-1)]


def depth_to_points(depth: np.ndarray, trunc_pixel: int) -> np.ndarray:
    """Depth map [H, W] -> [K, 3] (u*d, v*d, d) for pixels with depth
    > 0.1 below row trunc_pixel (box_np_ops.py:125-152, vectorized;
    row-major pixel order preserved)."""
    d = depth[trunc_pixel:]
    v, u = np.nonzero(d > 0.1)
    dv = d[v, u]
    return np.stack([u * dv, (v + trunc_pixel) * dv, dv], axis=-1)


def depth_to_lidar_points(depth, trunc_pixel, P2, r_rect, velo2cam):
    """Depth map -> lidar points (box_np_ops.py:154-176)."""
    pts = _to_hom(depth_to_points(depth, trunc_pixel))
    cam = pts @ np.linalg.inv(P2.T)
    return camera_to_lidar(cam, r_rect, velo2cam)


def boxes3d_to_corners3d_lidar(boxes3d: np.ndarray,
                               bottom_center: bool = True) -> np.ndarray:
    """[N, 7] lidar boxes (x,y,z,w,l,h,ry) -> [N, 8, 3] corners; z is the
    bottom face when bottom_center (box_np_ops.py:826-880)."""
    origin = (0.5, 0.5, 0.0) if bottom_center else (0.5, 0.5, 0.5)
    return center_to_corner_box3d(
        boxes3d[:, :3], boxes3d[:, 3:6], boxes3d[:, 6], origin, axis=2)
