"""Rotated-BEV overlap and 3D IoU as tensor ops.

Counterpart of ``bevfusion_tpu/ops/iou3d.py`` (reference mmdet3d/ops/iou3d
and BboxOverlaps3D(coordinate='lidar')): the overlap of two rotated
rectangles is one rectangle clipped by the four half-planes of the other
(Sutherland-Hodgman) in fixed-size vertex buffers (8 vertices, a 16-slot
emit buffer), batched over all box pairs. The shoelace sum runs in a fixed
pairwise order, the same on every device, so that the NMS kernel
(``csrc/nms.cu``, N1) repeats it bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["box_corners_bev", "overlap_corners", "iou_corners", "rotated_overlap_bev", "iou_bev",
           "iou_3d"]

_V = 8  # most vertices of the running polygon (quad ∩ quad <= 8)


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (cx, cy, dx, dy, yaw) -> counter-clockwise corners [..., 4, 2]."""
    cx, cy, dx, dy, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    hx, hy = dx / 2, dy / 2
    lx = torch.stack([hx, -hx, -hx, hx], -1)
    ly = torch.stack([hy, hy, -hy, -hy], -1)
    gx = cx[..., None] + lx * c[..., None] - ly * s[..., None]
    gy = cy[..., None] + lx * s[..., None] + ly * c[..., None]
    return torch.stack([gx, gy], -1)


def _clip_halfplane(poly, n, p, q):
    """Clip polygons ``poly [..., V, 2]`` (``n [...]`` vertices) by the
    half-plane left of the directed edge p -> q (``[..., 2]``)."""
    V = poly.shape[-2]
    idx = torch.arange(V, device=poly.device)
    nxt_idx = torch.where(idx + 1 < n[..., None], idx + 1, 0)
    nxt = torch.gather(poly, -2, nxt_idx[..., None].expand(*nxt_idx.shape, 2))
    d = q - p

    def side(v):
        return d[..., None, 0] * (v[..., 1] - p[..., None, 1]) \
            - d[..., None, 1] * (v[..., 0] - p[..., None, 0])

    s_cur, s_nxt = side(poly), side(nxt)
    in_cur, in_nxt = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = poly + (nxt - poly) * t[..., None]
    active = idx < n[..., None]
    emit_mask = torch.stack([active & in_cur, active & (in_cur != in_nxt)], -1).flatten(-2)
    emit_vals = torch.stack([poly, inter], -2).flatten(-3, -2)  # [..., 2V, 2]
    # the same integer sums as a scan along the last axis, taken along the
    # first: PyTorch's CUDA scan of a short innermost axis over many rows
    # took 1.6 ms a call for the 2V = 16 slots of 250,000 box pairs on an
    # NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's decode trace)
    pos = emit_mask.int().movedim(-1, 0).cumsum(0).movedim(0, -1) - 1
    pos = torch.where(emit_mask & (pos < V), pos, V).long()  # V = drop slot, as JAX drops
    out = poly.new_zeros(poly.shape[:-2] + (V + 1, 2))
    out.scatter_(-2, pos[..., None].expand(*pos.shape, 2), emit_vals)
    return out[..., :V, :], torch.clamp(emit_mask.sum(-1), max=V)


def _poly_area(poly, n):
    V = poly.shape[-2]
    idx = torch.arange(V, device=poly.device)
    nxt_idx = torch.where(idx + 1 < n[..., None], idx + 1, 0)
    nxt = torch.gather(poly, -2, nxt_idx[..., None].expand(*nxt_idx.shape, 2))
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    cross = torch.where(idx < n[..., None], cross, 0.0)
    # ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)): pairwise, in a fixed order
    for half in (4, 2, 1):
        cross = cross[..., :half] + cross[..., half:2 * half]
    return cross[..., 0].abs() / 2


def overlap_corners(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection areas [...] of rectangles given by their corners
    ``[..., 4, 2]`` (broadcast against each other): ``c1`` clipped by the
    four half-planes of ``c2``."""
    shape = torch.broadcast_shapes(c1.shape[:-2], c2.shape[:-2])
    poly = c1.new_zeros(shape + (_V, 2))
    poly[..., :4, :] = c1.expand(shape + (4, 2))
    n = torch.full(shape, 4, dtype=torch.long, device=c1.device)
    c2 = c2.expand(shape + (4, 2))
    for e in range(4):
        poly, n = _clip_halfplane(poly, n, c2[..., e, :], c2[..., (e + 1) % 4, :])
    return _poly_area(poly, n)


def iou_corners(c1: torch.Tensor, a1: torch.Tensor, c2: torch.Tensor, a2: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Rotated BEV IoU [..., N, M] of rectangles by corners (``c1 [..., N, 4,
    2]``, ``c2 [..., M, 4, 2]``) and areas (``a1 [..., N]``, ``a2 [..., M]``):
    the overlap over the union."""
    inter = overlap_corners(c1[..., :, None, :, :], c2[..., None, :, :, :])
    return inter / torch.clamp(a1[..., :, None] + a2[..., None, :] - inter, min=eps)


def rotated_overlap_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas [N, M] of rotated BEV boxes [*, 5]."""
    return overlap_corners(box_corners_bev(boxes1.float())[:, None],
                           box_corners_bev(boxes2.float())[None])


def iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotated BEV IoU [N, M] of boxes [*, 5] = (cx, cy, dx, dy, yaw): the
    overlap over the union of the two rectangles' areas."""
    return iou_corners(box_corners_bev(boxes1.float()), boxes1[:, 2] * boxes1[:, 3],
                       box_corners_bev(boxes2.float()), boxes2[:, 2] * boxes2[:, 3], eps)


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """3D IoU [N, M] of [*, 7] (x, y, z_bottom, dx, dy, dz, yaw) boxes: the
    rotated BEV overlap times the z overlap, over the union."""
    sel = [0, 1, 3, 4, 6]
    inter2d = rotated_overlap_bev(boxes1[:, sel], boxes2[:, sel])
    zmin1, zmax1 = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    zmin2, zmax2 = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    zo = torch.clamp(torch.minimum(zmax1[:, None], zmax2[None])
                     - torch.maximum(zmin1[:, None], zmin2[None]), min=0.0)
    inter = inter2d * zo
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / torch.clamp(v1[:, None] + v2[None] - inter, min=eps)
