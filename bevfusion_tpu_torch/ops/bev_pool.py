"""LSS BEV pooling: sum depth x context over the frustum points of each BEV
cell, with the interval kernel (``csrc/bev_pool.cu``) and its plain version.

Counterpart of ``bevfusion_tpu/ops/bev_pool.py`` (``cell_ids_from_geometry``,
``lss_bev_pool``) and of the TPU kernel ``ops/bev_pool_pallas.py:_kernel``.
The port keeps the pool in BEVPoolv2's interval form (PAPERS.md, arXiv
2211.17111): points outside the grid are dropped, the rest are stably
sorted by cell id, and ``PoolIntervals`` holds per sorted point its flat
index into depth and its pixel row into ctx, and per run of equal ids
(an interval) its start, length and cell. ``build_intervals`` makes it
from cell ids; ``models/vtransforms.py:build_pool_lut`` makes it from the
calibration, per frame (the in-graph route) or once (the LUT route).

The batch is folded into the flat indices (sample ``b``'s cells are
``b * Z*X*Y + cell``), so one launch pools the whole batch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import native

__all__ = ["PoolIntervals", "cell_ids_from_geometry", "build_intervals", "bev_pool",
           "bev_pool_plain"]


class PoolIntervals(NamedTuple):
    """The pool's interval form for a batch (all int32, on one device)."""
    ranks_depth: torch.Tensor       # [P] flat index into depth [B*N*D*fH*fW]
    ranks_feat: torch.Tensor        # [P] pixel row into ctx [B*N*fH*fW, C]
    interval_starts: torch.Tensor   # [R] first sorted point of each interval
    interval_lengths: torch.Tensor  # [R] points in each interval (>= 1)
    interval_cells: torch.Tensor    # [R] cell in the flat [B*Z*X*Y] grid, ascending


def cell_ids_from_geometry(geom: torch.Tensor, dx, bx, nx):
    """Quantize lidar-frame points ``geom [..., 3]`` to BEV cells:
    ``floor((p - (bx - dx/2)) / dx)``, in-grid where ``0 <= c < nx`` per axis.
    Returns (cell id ``(z*X + x)*Y + y`` within one sample's grid, valid)."""
    dx = torch.as_tensor(dx, dtype=torch.float32, device=geom.device)
    bx = torch.as_tensor(bx, dtype=torch.float32, device=geom.device)
    c = torch.floor((geom - (bx - dx / 2.0)) / dx).int()
    cx, cy, cz = c.unbind(-1)
    X, Y, Z = int(nx[0]), int(nx[1]), int(nx[2])
    valid = (cx >= 0) & (cx < X) & (cy >= 0) & (cy < Y) & (cz >= 0) & (cz < Z)
    return (cz * X + cx) * Y + cy, valid


def build_intervals(cell_ids: torch.Tensor, valid: torch.Tensor, num_cells: int) -> PoolIntervals:
    """The interval form from per-point cell ids ``[B, N, D, fH, fW]`` (ids
    within one sample's ``num_cells``-cell grid) and their ``valid`` mask."""
    B, N, D, fH, fW = cell_ids.shape
    HW, Np = fH * fW, N * D * fH * fW
    dev = cell_ids.device
    ids = cell_ids.reshape(B, Np).long() + torch.arange(B, device=dev)[:, None] * num_cells
    keep = torch.nonzero(valid.reshape(-1)).squeeze(1)
    ids_s, order = torch.sort(ids.reshape(-1)[keep], stable=True)
    ranks_depth = keep[order]
    b, i = ranks_depth // Np, ranks_depth % Np
    ranks_feat = (b * N + i // (D * HW)) * HW + i % HW
    cells, lengths = torch.unique_consecutive(ids_s, return_counts=True)
    starts = torch.cumsum(lengths, 0) - lengths
    return PoolIntervals(*(t.int() for t in (ranks_depth, ranks_feat, starts, lengths, cells)))


def _to_nchw(out: torch.Tensor, B: int, Z: int, X: int, Y: int) -> torch.Tensor:
    """[B*Z*X*Y, C] -> [B, Z*C, X, Y], channel z*C + c (the NCHW form of the
    JAX package's z-major [B, X, Y, Z*C])."""
    C = out.shape[-1]
    return out.view(B, Z, X, Y, C).permute(0, 1, 4, 2, 3).reshape(B, Z * C, X, Y)


def bev_pool_plain(depth: torch.Tensor, ctx: torch.Tensor, iv: PoolIntervals,
                   Z: int, X: int, Y: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``depth[ranks_depth] *
    ctx[ranks_feat]``, summed per interval with ``index_add_`` into a zeroed
    grid. depth [B, N, D, fH, fW], ctx [B, N, fH, fW, C] -> [B, Z*C, X, Y]."""
    B, C = depth.shape[0], ctx.shape[-1]
    vals = (depth.reshape(-1)[iv.ranks_depth.long(), None]
            * ctx.reshape(-1, C)[iv.ranks_feat.long()])
    cell_of_point = torch.repeat_interleave(iv.interval_cells.long(), iv.interval_lengths.long())
    out = vals.new_zeros((B * Z * X * Y, C)).index_add_(0, cell_of_point, vals)
    return _to_nchw(out, B, Z, X, Y)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = native.load_library("bev_pool").bevf_bev_pool_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 8 + [i32] * 5 + [vp]
    fn.restype = i32
    return fn


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _kernel_fn()


def _check_cuda_args(depth, ctx, iv: PoolIntervals):
    if depth.dim() != 5 or ctx.dim() != 5 or ctx.shape[:2] != depth.shape[:2] \
            or ctx.shape[2:4] != depth.shape[3:5]:
        raise ValueError(f"bev_pool: want depth [B, N, D, fH, fW] and ctx [B, N, fH, fW, C], "
                         f"got {tuple(depth.shape)} and {tuple(ctx.shape)}")
    named = {"depth": depth, "ctx": ctx, **iv._asdict()}
    for name, t in named.items():
        if t.device != depth.device:
            raise ValueError(f"bev_pool: {name} is on {t.device}, depth on {depth.device}")
        want = torch.float32 if name in ("depth", "ctx") else torch.int32
        if t.dtype != want:
            raise TypeError(f"bev_pool: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"bev_pool: {name} must be contiguous")
    if iv.ranks_depth.shape != iv.ranks_feat.shape or iv.ranks_depth.dim() != 1:
        raise ValueError("bev_pool: ranks_depth and ranks_feat must be [P]")
    R = iv.interval_cells.shape
    if iv.interval_starts.shape != R or iv.interval_lengths.shape != R or len(R) != 1:
        raise ValueError("bev_pool: interval_starts, _lengths and _cells must be [R]")


def bev_pool(depth: torch.Tensor, ctx: torch.Tensor, intervals: PoolIntervals,
             Z: int, X: int, Y: int) -> torch.Tensor:
    """``out[b, z*C + c, x, y] = sum over the points of cell (z, x, y) of
    depth[ranks_depth] * ctx[ranks_feat, c]``; 0 where no interval lands.
    depth [B, N, D, fH, fW], ctx [B, N, fH, fW, C] -> [B, Z*C, X, Y].

    CUDA tensors launch the hand-written kernel (fp32, contiguous, int32
    intervals) on the current stream; CPU tensors take ``bev_pool_plain``.
    An index outside its array raises on the CPU and trips a device-side
    assert in the kernel, as PyTorch's own CUDA index kernels do.
    ``bev_pool.launches`` counts kernel launches.
    """
    if depth.device.type == "cpu":
        return bev_pool_plain(depth, ctx, intervals, Z, X, Y)
    if depth.device.type != "cuda":
        raise ValueError(f"bev_pool: unsupported device {depth.device}")
    _check_cuda_args(depth, ctx, intervals)
    B, C = depth.shape[0], ctx.shape[-1]
    num_cells = B * Z * X * Y
    out = torch.zeros((num_cells, C), dtype=torch.float32, device=depth.device)
    R = intervals.interval_cells.shape[0]
    if R == 0:
        return _to_nchw(out, B, Z, X, Y)
    fn = _kernel_fn()
    ptrs = [t.data_ptr() for t in (depth, ctx, *intervals)]
    with torch.cuda.device(depth.device):
        rc = fn(*ptrs, out.data_ptr(), R, C, depth.numel(), ctx.numel() // C, num_cells,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bev_pool: kernel launch failed with cudaError {rc}")
    bev_pool.launches += 1
    return _to_nchw(out, B, Z, X, Y)


bev_pool.launches = 0
