"""Point-cloud voxelization with static caps: a fused mean, or the table.

Counterpart of ``bevfusion_tpu/ops/voxelize.py`` (``voxelize``,
``Voxelization``): hard voxelization of at most ``max_points`` points per
voxel and at most ``max_voxels`` voxels, then either the per-voxel mean,
as BEVFusion's voxelize step does (reference fusion_models/bevfusion.py:
171-197), or (``reduce=None``) the unreduced point table the pillar
encoders read. Sort-based and free of host syncs:

  1. quantize points to x-major voxel ids (out of range -> sentinel),
  2. stable-sort by id (arrival order kept within a voxel),
  3. run heads/tails give each voxel's first point and count,
  4. the mean sums the first ``max_points`` points of each voxel; the
     table gathers them, one row of ``max_points`` slots a voxel.

Voxels come out sorted by linear id ``(x*ny + y)*nz + z``, the sparse
encoder's site order. When more than ``max_voxels`` voxels are occupied
the smallest ids survive (the JAX package's documented rule).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["VoxelizationOutput", "voxelize", "Voxelization"]


class VoxelizationOutput(NamedTuple):
    feats: torch.Tensor  # [..., M, C] mean over the stored points, or [..., M, max_points, C]
    coords: torch.Tensor  # [..., M, 3] int32 (x, y, z); invalid rows -1
    num_points: torch.Tensor  # [..., M] int32 stored points per voxel
    mask: torch.Tensor  # [..., M] bool


def _grid_dims(point_cloud_range, voxel_size) -> Tuple[int, int, int]:
    pcr = np.asarray(point_cloud_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    nx, ny, nz = np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64)
    return int(nx), int(ny), int(nz)


def voxelize(points: torch.Tensor, points_mask: torch.Tensor, voxel_size: Sequence[float],
             point_cloud_range: Sequence[float], max_points: int,
             max_voxels: int, reduce: Optional[str] = "mean") -> VoxelizationOutput:
    """One sample: points [P, C] (x, y, z, ...), points_mask [P] bool.
    ``reduce="mean"``: feats [M, C], the mean of each voxel's stored points;
    ``reduce=None``: feats [M, max_points, C], each voxel's first
    ``max_points`` points in arrival order, slots past its count zero."""
    if reduce not in ("mean", None):
        raise NotImplementedError(f"voxelize: reduce={reduce!r} (the port takes 'mean' or None)")
    P, C = points.shape
    dev = points.device
    nx, ny, nz = _grid_dims(point_cloud_range, voxel_size)
    num_cells = nx * ny * nz
    pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)

    cf = torch.floor((points[:, :3] - pcr) / vs).int()
    cx, cy, cz = cf.unbind(1)
    pvalid = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
              & points_mask)
    ids = torch.where(pvalid, (cx.long() * ny + cy) * nz + cz, num_cells)
    ids_s, order = torch.sort(ids, stable=True)

    M = max_voxels
    headb = torch.ones(P, dtype=torch.bool, device=dev)
    headb[1:] = ids_s[1:] != ids_s[:-1]
    tailb = torch.ones(P, dtype=torch.bool, device=dev)
    tailb[:-1] = ids_s[:-1] != ids_s[1:]
    seg = torch.cumsum(headb, 0) - 1  # voxel index of each sorted point
    pos = torch.arange(P, device=dev)
    seg_clip = seg.clamp(max=M)  # M = dump slot for voxels past the cap
    starts = torch.full((M + 1,), P, dtype=torch.long, device=dev)
    starts.scatter_(0, torch.where(headb, seg_clip, M), pos)
    ends = torch.full((M + 1,), P, dtype=torch.long, device=dev)
    ends.scatter_(0, torch.where(tailb, seg_clip, M), pos + 1)
    starts, ends = starts[:M], ends[:M]
    count = torch.where(starts < P, ends - starts, 0)

    vox_ids = ids_s[starts.clamp(max=P - 1)]
    vmask = (count > 0) & (vox_ids < num_cells)
    stored = torch.where(vmask, count.clamp(max=max_points), 0).int()
    coords = torch.stack([vox_ids // (ny * nz), (vox_ids // nz) % ny, vox_ids % nz], -1)
    coords = torch.where(vmask[:, None], coords, -1).int()

    if reduce is None:  # one gather of each voxel's slots from the sorted points
        slot = torch.arange(max_points, device=dev)
        src = (starts[:, None] + slot).clamp(max=P - 1)
        slot_valid = (slot < stored[:, None]) & vmask[:, None]
        table = points[order[src.reshape(-1)]].view(M, max_points, C)
        return VoxelizationOutput(torch.where(slot_valid[..., None], table, 0.0), coords,
                                  stored, vmask)

    # mean over the first max_points points of each voxel; a point's
    # place in its voxel comes from the running max of head positions
    seg_start = torch.cummax(torch.where(headb, pos, 0), 0).values
    use = (seg < M) & (pos - seg_start < max_points) & (ids_s < num_cells)
    vals = torch.where(use[:, None], points[order], 0.0)
    sums = points.new_zeros((M + 1, C)).index_add_(0, torch.where(use, seg, M), vals)[:M]
    feats = sums / stored.clamp(min=1)[:, None]
    feats = torch.where(vmask[:, None], feats, 0.0)
    return VoxelizationOutput(feats, coords, stored, vmask)


class Voxelization:
    """Config-driven voxelizer. ``max_voxels`` may be a (train, test) pair
    like the reference's; ``max_num_points <= 0`` keeps every point of a
    voxel (dynamic voxelization); ``reduce`` as ``voxelize``'s."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points, max_voxels=20000,
                 reduce: Optional[str] = "mean"):
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_num_points = max_num_points
        if isinstance(max_voxels, (tuple, list)):
            self.max_voxels_train, self.max_voxels_test = max_voxels
        else:
            self.max_voxels_train = self.max_voxels_test = max_voxels
        self.reduce = reduce

    def __call__(self, points: torch.Tensor, points_mask: torch.Tensor,
                 training: bool = False) -> VoxelizationOutput:
        """points [B, P, C], points_mask [B, P] -> per-sample outputs
        stacked on a leading batch axis ([B, M, ...])."""
        max_voxels = self.max_voxels_train if training else self.max_voxels_test
        max_points = self.max_num_points
        if max_points is None or max_points <= 0:
            max_points = points.shape[-2]
        outs = [voxelize(p, m, self.voxel_size, self.point_cloud_range, max_points, max_voxels,
                         self.reduce)
                for p, m in zip(points, points_mask)]
        return VoxelizationOutput(*(torch.stack(xs) for xs in zip(*outs)))
