"""PointNet++-family ops, with furthest point sampling as a hand-written
kernel (``csrc/pointnet.cu``, the custom op ``bevfusion::furthest_point_sample``
of ``ops/library.py``) and its plain version.

Counterpart of ``bevfusion_tpu/ops/pointnet.py`` (the reference's op
packages ops/ball_query, ops/knn, ops/group_points, ops/interpolate,
ops/furthest_point_sample, ops/gather_points and ops/paconv): masked dense
computations, a distance matrix feeding a sort instead of a neighbour
kernel. Every sort is stable, so equal keys keep index order, as
``jnp.sort`` / ``jax.lax.top_k`` / ``jnp.argmax`` resolve ties to the lowest
index. Layouts as the JAX package's: one sample's points ``[N, 3]``;
``furthest_point_sample`` also takes a batch ``[B, N, 3]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import native

__all__ = ["square_distance", "ball_query", "knn", "furthest_point_sample",
           "furthest_point_sample_plain", "gather_points", "group_points", "three_nn",
           "three_interpolate", "interpolation_weights", "assign_score_withk", "FPS_MAX_POINTS",
           "fps_plan"]

FPS_MAX_POINTS = 32768  # the kernel keeps each point's running distance in a register


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [M, 3] -> [N, M] squared euclidean distances
    (|a|^2 - 2 a.b + |b|^2, the JAX package's form)."""
    return (a * a).sum(-1, keepdim=True) - 2 * a @ b.T + (b * b).sum(-1)[None]


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               xyz_mask: Optional[torch.Tensor] = None):
    """For each query of new_xyz [S, 3], the first ``nsample`` points of
    xyz [N, 3] (in index order) within ``radius``, padded with the first
    hit (0 where none). Returns (idx [S, nsample] int32, valid bool)."""
    d2 = square_distance(new_xyz, xyz)
    if xyz_mask is not None:
        d2 = torch.where(xyz_mask[None], d2, float("inf"))
    N = xyz.shape[0]
    iota = torch.arange(N, device=xyz.device).expand_as(d2)
    key = torch.where(d2 <= radius ** 2, iota, N)
    first = torch.sort(key, dim=1).values[:, :nsample]  # [S, min(N, nsample)], as JAX
    valid = first < N
    head = torch.where(valid[:, :1], first[:, :1], 0)
    return torch.where(valid, first, head).int(), valid


def knn(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
        xyz_mask: Optional[torch.Tensor] = None):
    """The k nearest points of xyz [N, 3] to each query of new_xyz [S, 3],
    nearest first, equal distances in index order: (idx [S, k] int32,
    dists [S, k])."""
    d2 = square_distance(new_xyz, xyz)
    if xyz_mask is not None:
        d2 = torch.where(xyz_mask[None], d2, float("inf"))
    d, idx = torch.sort(d2, dim=1, stable=True)
    return idx[:, :k].int(), d[:, :k].clamp(min=0).sqrt()


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int,
                                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: xyz [B, N, 3], mask [B, N] bool
    or None -> [B, npoint] int32. Sample 0 is point 0; each later one is the
    point furthest (squared distance ``(dx*dx + dy*dy) + dz*dz``, fp32) from
    those taken, the first of equal ones; masked points count -1 and are
    taken only when nothing else is left. A loop of ``npoint - 1`` rounds,
    as the JAX package's ``lax.fori_loop``."""
    B, N, _ = xyz.shape
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    if mask is not None:
        dist = torch.where(mask, dist, -1.0)
    out = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    last = out[:, 0]
    for i in range(1, npoint):
        p = xyz.gather(1, last[:, None, None].expand(B, 1, 3))
        dx, dy, dz = (xyz - p).unbind(-1)
        d = dx * dx + dy * dy + dz * dz
        if mask is not None:
            d = torch.where(mask, d, -1.0)
        dist = torch.minimum(dist, d)
        last = dist.argmax(1)
        out[:, i] = last
    return out.int()


FPS_PLAN_KEYS = ("threads", "points", "smem_bytes", "cluster")
_FPS_THREADS = 1024
_FPS_BLOCK_POINTS = 8 * _FPS_THREADS  # a block's points at most: 8 a thread, in registers
_FPS_CLUSTER = 4  # the blocks of a sample past 8,192 points


def fps_plan(n: int) -> dict:
    """The launch of the kernel for a sample of ``n`` points: ``threads`` a
    block, ``points`` a thread (all in registers), the static shared bytes
    a block (``csrc/pointnet.cu``'s two parity buffers of warp slots, and
    of block slots in a cluster), and ``cluster``, the blocks of a sample
    (a thread block cluster): one up to 8,192 points, four past that, each
    block with its share. A block's threads keep min(ceil(its points /
    512), 8) points each, the block sized to its points. Raises ValueError
    on a size the kernel refuses."""
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"fps_plan: n {n} (1..{FPS_MAX_POINTS})")
    cl = _FPS_CLUSTER if n > _FPS_BLOCK_POINTS else 1
    local = -(-n // cl)
    points = min(-(-local // 512), 8)
    threads = -(-(-(-local // points)) // 32) * 32
    return dict(zip(FPS_PLAN_KEYS, (threads, points, 2 * (32 + (cl if cl > 1 else 0)) * 24, cl)))


@functools.lru_cache(maxsize=None)
def _library():
    lib = native.load_library("pointnet")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bevf_furthest_point_sample.argtypes = [vp, vp, vp] + [i32] * 6 + [vp]
    lib.bevf_furthest_point_sample.restype = i32
    return lib


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _library()


def _launch_fps(xyz: torch.Tensor, npoint: int, mask: Optional[torch.Tensor]):
    """Check the operands, allocate the output and launch the kernel on the
    current stream (as ``fps_plan`` gives it); returns (idx [B, npoint]
    int32, whether it launched)."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"furthest_point_sample: want fp32 xyz [B, N, 3], got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if mask is not None and (mask.shape != (B, N) or mask.dtype != torch.bool
                             or mask.device != xyz.device):
        raise ValueError(f"furthest_point_sample: mask must be bool [B, N] on {xyz.device}")
    if not 1 <= N <= FPS_MAX_POINTS or npoint < 1:
        raise ValueError(f"furthest_point_sample: N {N} (1..{FPS_MAX_POINTS}), npoint {npoint}")
    plan = fps_plan(N)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out, False
    # coordinates as [B, 3, N]: neighbouring threads read neighbouring floats
    soa = xyz.transpose(1, 2).contiguous()
    m = None if mask is None else mask.to(torch.uint8).contiguous()
    with torch.cuda.device(xyz.device):
        rc = _library().bevf_furthest_point_sample(
            soa.data_ptr(), None if m is None else m.data_ptr(), out.data_ptr(), B, N, npoint,
            plan["threads"], plan["points"], plan["cluster"],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"furthest_point_sample: kernel launch failed with cudaError {rc}")
    return out, True


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative furthest point sampling from point 0: xyz [N, 3] (or a
    batch [B, N, 3]), mask [N] ([B, N]) bool or None -> the ``npoint``
    indices [npoint] ([B, npoint]) int32 (the rule of
    ``furthest_point_sample_plain``).

    The op ``bevfusion::furthest_point_sample`` (``ops/library.py``): CUDA
    tensors launch the hand-written kernel (one block a sample, fp32, N <=
    ``FPS_MAX_POINTS``, one barrier a round: ``fps_plan``) on the current
    stream; CPU tensors take the plain
    version. Both compute each distance with the same rounded operations
    and break ties alike, so they give the same indices.
    ``furthest_point_sample.launches`` counts kernel launches."""
    one = xyz.dim() == 2
    if one:
        xyz, mask = xyz[None], None if mask is None else mask[None]
    out = torch.ops.bevfusion.furthest_point_sample(xyz.contiguous(), npoint, mask)
    return out[0] if one else out


furthest_point_sample.launches = 0


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [N, C], idx [...] -> feats[idx] [..., C]."""
    return feats[idx.long()]


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [N, C], idx [S, K] -> [S, K, C]."""
    return feats[idx.long()]


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_mask: Optional[torch.Tensor] = None):
    """The 3 nearest known points of each unknown point: (dists [N, 3],
    idx [N, 3])."""
    idx, d = knn(3, known, unknown, known_mask)
    return d, idx


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """feats [M, C], idx [N, 3], weight [N, 3] -> [N, C], the weighted sum
    of the three rows."""
    return (group_points(feats, idx) * weight[..., None]).sum(1)


def interpolation_weights(dists: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse squared distances [N, 3], normalised to sum 1 a row."""
    recip = 1.0 / (dists * dists).clamp(min=eps)
    return recip / recip.sum(-1, keepdim=True)


def assign_score_withk(scores: torch.Tensor, point_feats: torch.Tensor,
                       center_feats: torch.Tensor, knn_idx: torch.Tensor,
                       aggregate: str = "sum") -> torch.Tensor:
    """PAConv's kernel assembly: scores [S, K, M], point / center feats
    [N, M, C], knn_idx [S, K] -> [S, K, C], ``sum_m score_m *
    (point_feats[nbr, m] - center_feats[center, m])`` with the centre each
    row's first neighbour. ``aggregate`` is accepted and, as in the JAX
    package, only "sum" is computed."""
    nbr = point_feats[knn_idx.long()]  # [S, K, M, C]
    center = center_feats[knn_idx[:, :1].long()]  # [S, 1, M, C]
    return torch.einsum("skm,skmc->skc", scores, nbr - center)
