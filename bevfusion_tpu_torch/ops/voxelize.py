"""Point-cloud voxelization with static caps: a fused reduction, or the table.

Counterpart of ``bevfusion_tpu/ops/voxelize.py`` (``voxelize``,
``voxelize_batch``, ``Voxelization``, ``dynamic_scatter``,
``DynamicScatter``): hard voxelization of at most ``max_points`` points per
voxel and at most ``max_voxels`` voxels, then either a per-voxel reduction
of the stored points -- the mean, as BEVFusion's voxelize step does
(reference fusion_models/bevfusion.py:171-197), the sum or the max -- or
(``reduce=None``) the unreduced point table the pillar encoders read.
``dynamic_scatter`` reduces arbitrary per-point features over their voxel
coords with no per-voxel cap (reference ops/voxel/scatter_points.py:8-104).
Sort-based and free of host syncs:

  1. quantize points to x-major voxel ids (out of range -> sentinel),
  2. stable-sort by id (arrival order kept within a voxel),
  3. run heads/tails give each voxel's first point and count,
  4. a reduction sums (or maxes) the first ``max_points`` points of each
     voxel; the table gathers them, one row of ``max_points`` slots a voxel.

Voxels come out sorted by linear id ``(x*ny + y)*nz + z``, the sparse
encoder's site order. When more than ``max_voxels`` voxels are occupied
the smallest ids survive (the JAX package's documented rule).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["VoxelizationOutput", "voxelize", "voxelize_batch", "Voxelization",
           "dynamic_scatter", "DynamicScatter"]

REDUCES = ("mean", "sum", "max")


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
    ``reduce="mean"`` / ``"sum"`` / ``"max"``: feats [M, C], that reduction
    of each voxel's stored points (its first ``max_points`` in arrival
    order); ``reduce=None``: feats [M, max_points, C], those points, slots
    past its count zero. Rows of no voxel are zero."""
    if reduce not in REDUCES + (None,):
        raise ValueError(f"voxelize: reduce={reduce!r} (one of {REDUCES} or None)")
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

    # the reduction over the first max_points points of each voxel; a
    # point's place in its voxel comes from the running max of head positions
    seg_start = torch.cummax(torch.where(headb, pos, 0), 0).values
    use = (seg < M) & (pos - seg_start < max_points) & (ids_s < num_cells)
    feats = _segment_reduce(points[order], torch.where(use, seg, M), use, M, reduce)
    if reduce == "mean":
        feats = feats / stored.clamp(min=1)[:, None]
    feats = torch.where(vmask[:, None], feats, 0.0)
    return VoxelizationOutput(feats, coords, stored, vmask)


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, use: torch.Tensor, M: int,
                    reduce: str) -> torch.Tensor:
    """[M, C]: the sum ("mean", "sum") or the max ("max") of the rows of
    ``vals`` [N, C] with ``use`` over their segment ``seg`` (``M`` for the
    others); a segment with no row is 0 for a sum and -inf for the max."""
    C = vals.shape[1]
    if reduce == "max":
        vals = torch.where(use[:, None], vals, float("-inf"))
        out = vals.new_full((M + 1, C), float("-inf"))
        return out.scatter_reduce_(0, seg[:, None].expand(-1, C), vals, "amax")[:M]
    vals = torch.where(use[:, None], vals, 0.0)
    return vals.new_zeros((M + 1, C)).index_add_(0, seg, vals)[:M]


def voxelize_batch(points: torch.Tensor, points_mask: torch.Tensor,
                   voxel_size: Sequence[float], point_cloud_range: Sequence[float],
                   max_points: int, max_voxels: int, reduce: Optional[str] = "mean"):
    """Each sample of points [B, P, C] / points_mask [B, P] voxelized, as one
    flat voxel list: (feats [B*M, ...], coords [B*M, 4] int32 (b, x, y, z),
    num_points [B*M], mask [B*M]); the batch index rides in the coords of
    every row, padding too (the JAX package's layout, reference
    bevfusion.py:181)."""
    B, M = points.shape[0], max_voxels
    outs = [voxelize(p, m, voxel_size, point_cloud_range, max_points, max_voxels, reduce)
            for p, m in zip(points, points_mask)]
    feats, coords, num, mask = (torch.stack(xs) for xs in zip(*outs))
    b = torch.arange(B, dtype=torch.int32, device=points.device).repeat_interleave(M)
    coords4 = torch.cat([b[:, None], coords.reshape(B * M, 3)], 1)
    return feats.reshape((B * M,) + feats.shape[2:]), coords4, num.reshape(-1), mask.reshape(-1)


def dynamic_scatter(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                    grid_dims: Sequence[int], max_voxels: int, reduce: str = "mean"):
    """Per-point features [P, C] reduced over their voxels: coords [P, 3]
    int (x, y, z), valid [P] bool, ``grid_dims`` (nx, ny, nz). A point
    counts where it is valid and inside the grid; every such point of a
    voxel is reduced (no per-voxel cap). Returns (voxel feats [max_voxels,
    C], voxel coords [max_voxels, 3] int32, -1 on padding, mask
    [max_voxels]), voxels in x-major id order, the ``max_voxels``
    smallest ids kept; ``reduce``: mean, sum or max (over present points
    only)."""
    if reduce not in REDUCES:
        raise ValueError(f"dynamic_scatter: reduce={reduce!r} (one of {REDUCES})")
    nx, ny, nz = (int(d) for d in grid_dims)
    num_cells, M, dev = nx * ny * nz, max_voxels, feats.device
    cx, cy, cz = coords.long().unbind(1)
    ok = valid & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
    ids = torch.where(ok, (cx * ny + cy) * nz + cz, num_cells)
    ids_s, order = torch.sort(ids, stable=True)
    headb = torch.ones_like(ids_s, dtype=torch.bool)
    headb[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(headb, 0) - 1
    use = (seg < M) & (ids_s < num_cells)
    seg_c = torch.where(use, seg, M)
    counts = torch.zeros(M + 1, dtype=torch.long, device=dev).index_add_(
        0, seg_c, use.long())[:M]
    vmask = counts > 0
    out = _segment_reduce(feats[order], seg_c, use, M, reduce)
    if reduce == "mean":
        out = out / counts.clamp(min=1)[:, None].to(out.dtype)
    out = torch.where(vmask[:, None], out, 0.0)
    vox_ids = torch.full((M + 1,), num_cells, dtype=torch.long, device=dev).scatter_(
        0, torch.where(headb & use, seg_c, M), ids_s)[:M]
    vcoords = torch.stack([vox_ids // (ny * nz), (vox_ids // nz) % ny, vox_ids % nz], -1)
    return out, torch.where(vmask[:, None], vcoords, -1).int(), vmask


class DynamicScatter:
    """The reference's ``DynamicScatter`` (ops/voxel/scatter_points.py:96-104):
    points [P, C] with xyz leading, quantised to the grid of ``voxel_size``
    over ``point_cloud_range``, then ``dynamic_scatter`` of the points
    themselves, the mean (``average_points``) or the max."""

    def __init__(self, voxel_size, point_cloud_range, average_points: bool,
                 max_voxels: int = 65536):
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.average_points = average_points
        self.max_voxels = max_voxels

    def __call__(self, points: torch.Tensor, points_mask: torch.Tensor):
        dims = _grid_dims(self.point_cloud_range, self.voxel_size)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=points.device)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=points.device)
        cf = torch.floor((points[:, :3] - pcr) / vs).int()
        return dynamic_scatter(points, cf, points_mask, dims, self.max_voxels,
                               "mean" if self.average_points else "max")


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
