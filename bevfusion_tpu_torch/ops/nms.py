"""Greedy NMS as keep masks: circle NMS and rotated BEV NMS, with the
greedy pass as a hand-written kernel (``csrc/nms.cu``, the custom op
``bevfusion::greedy_suppress`` of ``ops/library.py``) and its plain
version.

Counterpart of ``bevfusion_tpu/ops/nms.py`` (``_greedy_suppress``,
``circle_nms_mask``, ``nms_bev_mask``; reference circle_nms,
mmdet3d/core/post_processing/box3d_nms.py:181-219, and nms_gpu,
mmdet3d/ops/iou3d/iou3d_utils.py:23-49). Detections are sorted by score
(invalid ones last, ties in index order: a stable sort, as ``jnp.argsort``
is), the suppression matrix is built with tensor ops in that order, and
the greedy pass clears every later detection that a kept one suppresses.
The result is a keep mask over the original indices (fixed shapes), and
an invalid detection is never kept. Every function takes a batch of
problems, ``[P, N, ...]``, so one kernel launch serves a frame's batch.
``box3d_multiclass_nms_mask`` and ``aligned_3d_nms_mask`` are not ported
yet: no config reaches them (ROADMAP Queue 1 #9).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import native
from .iou3d import iou_bev

__all__ = ["score_order", "greedy_suppress", "greedy_suppress_plain", "circle_suppression",
           "bev_suppression", "circle_nms_mask", "nms_bev_mask"]

MAX_N = 49152  # the kernel keeps one flag byte per detection in shared memory


def score_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[P, N] -> the indices [P, N] (int64) by descending score, invalid
    detections last, equal scores in index order."""
    key = torch.where(valid, -scores, torch.full_like(scores, float("inf")))
    return torch.sort(key, dim=-1, stable=True).indices


def greedy_suppress_plain(sup: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``sup [P, N, N]`` bool in score
    order (row i suppresses column j), ``order [P, N]`` the score order ->
    keep ``[P, N]`` bool in the original index order. A loop over score
    rank, as the JAX package's ``lax.fori_loop``."""
    P, N = order.shape
    sup = sup & torch.ones(N, N, dtype=torch.bool, device=sup.device).triu(1)
    keep = torch.ones(P, N, dtype=torch.bool, device=sup.device)
    for i in range(N):
        keep &= ~(sup[:, i] & keep[:, i:i + 1])
    return torch.zeros_like(keep).scatter_(1, order, keep)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = native.load_library("nms").bevf_greedy_suppress
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i32, i32, vp]
    fn.restype = i32
    return fn


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _kernel_fn()


def _check_cuda_args(sup: torch.Tensor, order: torch.Tensor) -> None:
    if sup.dim() != 3 or order.dim() != 2 or sup.shape != order.shape + order.shape[-1:]:
        raise ValueError(f"greedy_suppress: want sup [P, N, N] and order [P, N], got "
                         f"{tuple(sup.shape)} and {tuple(order.shape)}")
    if order.device != sup.device:
        raise ValueError(f"greedy_suppress: order is on {order.device}, sup on {sup.device}")
    if sup.dtype != torch.bool or order.dtype != torch.int64:
        raise TypeError(f"greedy_suppress: want bool sup and int64 order, got {sup.dtype} and "
                        f"{order.dtype}")
    if not (sup.is_contiguous() and order.is_contiguous()):
        raise ValueError("greedy_suppress: sup and order must be contiguous")
    if order.shape[1] > MAX_N:
        raise ValueError(f"greedy_suppress: N {order.shape[1]} > {MAX_N}")


def _launch_suppress(sup: torch.Tensor, order: torch.Tensor):
    """Check the operands, allocate keep and launch the kernel on the
    current stream; returns (keep, whether it launched: an empty problem
    launches nothing)."""
    _check_cuda_args(sup, order)
    P, N = order.shape
    keep = torch.zeros((P, N), dtype=torch.bool, device=sup.device)
    if P == 0 or N == 0:
        return keep, False
    with torch.cuda.device(sup.device):
        rc = _kernel_fn()(sup.data_ptr(), order.data_ptr(), keep.data_ptr(), P, N,
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"greedy_suppress: kernel launch failed with cudaError {rc}")
    return keep, True


def greedy_suppress(sup: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The greedy pass: keep ``[P, N]`` bool in the original index order from
    ``sup [P, N, N]`` (bool, score order; row i suppresses column j > i) and
    the score ``order [P, N]`` (int64, a permutation per problem).

    The op ``bevfusion::greedy_suppress`` (``ops/library.py``): CUDA tensors
    launch the hand-written kernel (one block per problem) on the current
    stream; CPU tensors take ``greedy_suppress_plain``. Boolean in and out,
    so both give the same bits. ``greedy_suppress.launches`` counts kernel
    launches."""
    return torch.ops.bevfusion.greedy_suppress(sup, order)


greedy_suppress.launches = 0


def circle_suppression(centers: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                       radius_sq: float):
    """Circle NMS's input to the greedy pass: centers ``[P, N, 2]``, scores
    and valid ``[P, N]`` -> (sup ``[P, N, N]`` bool in score order: the
    squared center distance within ``radius_sq``, the score order)."""
    order = score_order(scores, valid)
    c = torch.gather(centers, 1, order[..., None].expand(-1, -1, centers.shape[-1]))
    d2 = ((c[:, :, None] - c[:, None]) ** 2).sum(-1)
    return (d2 <= radius_sq).contiguous(), order


def bev_suppression(boxes_bev: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float):
    """Rotated BEV NMS's input to the greedy pass (nms_gpu's rule):
    ``boxes_bev [P, N, 5]`` = (cx, cy, dx, dy, yaw) -> (sup ``[P, N, N]``
    bool in score order: BEV IoU above ``iou_threshold``, the score order)."""
    order = score_order(scores, valid)
    b = torch.gather(boxes_bev, 1, order[..., None].expand(-1, -1, boxes_bev.shape[-1]))
    return torch.stack([iou_bev(bp, bp) > iou_threshold for bp in b]), order


def circle_nms_mask(centers: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    radius_sq: float) -> torch.Tensor:
    """A detection is suppressed by a higher-scoring kept one whose center
    is within ``sqrt(radius_sq)``. Returns keep ``[P, N]``."""
    return greedy_suppress(*circle_suppression(centers, scores, valid, radius_sq)) & valid


def nms_bev_mask(boxes_bev: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """A detection is suppressed by a higher-scoring kept one whose BEV IoU
    with it exceeds ``iou_threshold``. Returns keep ``[P, N]``."""
    return greedy_suppress(*bev_suppression(boxes_bev, scores, valid, iou_threshold)) & valid
