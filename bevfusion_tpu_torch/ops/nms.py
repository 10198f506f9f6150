"""Greedy NMS as keep masks: circle NMS and rotated BEV NMS, as two
hand-written kernels (``csrc/nms.cu``, the custom ops
``bevfusion::suppression_words`` and ``bevfusion::greedy_suppress_words``
of ``ops/library.py``) and their plain versions.

Counterpart of ``bevfusion_tpu/ops/nms.py`` (``_greedy_suppress``,
``circle_nms_mask``, ``nms_bev_mask``, ``box3d_multiclass_nms_mask``,
``aligned_3d_nms_mask``; reference circle_nms,
mmdet3d/core/post_processing/box3d_nms.py:181-219, box3d_multiclass_nms
:8, aligned_3d_nms :129, and nms_gpu, mmdet3d/ops/iou3d/iou3d_utils.py:23-49).
Detections are sorted by score (invalid ones last, ties in index order: a
stable sort, as ``jnp.argsort`` is). N1 (``suppression_words``) turns the
sorted boxes into suppression words: bit ``j % 64`` of word ``j // 64`` of
row i is set where j > i and row i suppresses column j (circle: the
squared center distance within the radius; rotated: the BEV IoU above the
threshold). N2 (``greedy_suppress_words``) runs the greedy pass on the
words: a kept detection clears every later one it suppresses. The result is
a keep mask over the original indices (fixed shapes), and an invalid
detection is never kept. Every function takes a batch of problems,
``[P, N, ...]``, each with its own mode and threshold in N1, so one launch
of each kernel serves a frame's problems (``CenterHead.get_bboxes`` runs its
tasks so); ``box3d_multiclass_nms_mask`` and ``aligned_3d_nms_mask`` take
one problem as the JAX functions do (the multi-class one runs its classes
as the problems of one launch).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import native
from .iou3d import box_corners_bev, iou_corners

__all__ = ["MAX_N", "GEOM", "score_order", "words_count", "pack_words", "unpack_words",
           "box_geometry", "center_geometry", "suppression_words", "suppression_words_plain",
           "near_threshold", "greedy_suppress_words", "greedy_suppress_words_plain", "greedy_suppress",
           "greedy_suppress_plain", "circle_suppression", "bev_suppression", "circle_nms_mask",
           "nms_bev_mask", "box3d_multiclass_nms_mask", "aligned_3d_nms_mask"]

MAX_N = 49152  # the kernels' limit: N2's 16-row chunks of words fill its shared memory there
GEOM = 9  # N1's floats a box: the BEV corners x0 y0 .. x3 y3 and the area (a circle: its center)
_BITS = 64


def score_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[P, N] -> the indices [P, N] (int64) by descending score, invalid
    detections last, equal scores in index order."""
    key = torch.where(valid, -scores, torch.full_like(scores, float("inf")))
    return torch.sort(key, dim=-1, stable=True).indices


def words_count(n: int) -> int:
    """The 64-bit words a row of ``n`` columns takes."""
    return (n + _BITS - 1) // _BITS


def _bit_values(device) -> torch.Tensor:
    return torch.ones(_BITS, dtype=torch.int64, device=device) << torch.arange(_BITS, device=device)


def pack_words(sup: torch.Tensor) -> torch.Tensor:
    """``sup [P, N, N]`` bool -> words ``[P, N, ceil(N / 64)]`` int64: bit
    ``j % 64`` of word ``j // 64`` of row i is ``sup[:, i, j]`` (bit 63 the
    sign bit)."""
    P, N, _ = sup.shape
    W = words_count(N)
    bits = torch.nn.functional.pad(sup, (0, W * _BITS - N)).view(P, N, W, _BITS)
    # distinct bits: the sum carries nothing, so it is their OR (wrapping into the sign)
    return (bits.long() * _bit_values(sup.device)).sum(-1)


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """``pack_words``'s inverse: words ``[P, N, W]`` -> ``[P, N, n]`` bool."""
    P, N, W = words.shape
    bits = (words[..., None] & _bit_values(words.device)) != 0
    return bits.view(P, N, W * _BITS)[..., :n]


def box_geometry(boxes_bev: torch.Tensor) -> torch.Tensor:
    """N1's rows of rotated boxes: ``boxes_bev [P, N, 5]`` = (cx, cy, dx, dy,
    yaw) -> ``[P, N, 9]`` fp32: the corners (``iou3d.box_corners_bev``) and
    the area dx * dy, as ``iou3d.iou_bev`` computes them."""
    b = boxes_bev.float()
    return torch.cat([box_corners_bev(b).flatten(-2), (b[..., 2] * b[..., 3])[..., None]], -1)


def center_geometry(centers: torch.Tensor) -> torch.Tensor:
    """N1's rows of circle problems: ``centers [P, N, 2]`` -> ``[P, N, 9]``
    fp32, the center in the first two columns."""
    c = centers.float()
    return torch.cat([c, c.new_zeros(c.shape[:-1] + (GEOM - 2,))], -1)


def suppression_words_plain(geom: torch.Tensor, rotated: torch.Tensor,
                            thr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of N1: ``geom [P, N, 9]`` in score order
    (``box_geometry`` or ``center_geometry`` rows), ``rotated [P]`` bool,
    ``thr [P]`` fp32 -> words ``[P, N, ceil(N / 64)]`` int64 (``pack_words``
    of the suppression matrix, j > i only). A rotated problem compares its
    ``iou3d.iou_corners`` with ``thr`` (``>``), a circle problem its squared
    center distances (``<=``)."""
    P, N, _ = geom.shape
    sup = torch.zeros((P, N, N), dtype=torch.bool, device=geom.device)
    rot = rotated.tolist()
    circles = [p for p in range(P) if not rot[p]]
    if circles:
        c = geom[circles, :, :2]
        d2 = ((c[:, :, None] - c[:, None]) ** 2).sum(-1)
        sup[circles] = d2 <= thr[circles, None, None]
    for p in range(P):  # one [N, N] IoU at a time: the clip's buffers are 16 floats a pair
        if rot[p]:
            corners, area = geom[p, :, :8].view(N, 4, 2), geom[p, :, 8]
            sup[p] = iou_corners(corners, area, corners, area) > thr[p]
    return pack_words(sup & torch.ones(N, N, dtype=torch.bool, device=geom.device).triu(1))


def near_threshold(geom: torch.Tensor, rotated: torch.Tensor, thr: torch.Tensor,
                   tol: float = 2.0 ** -20) -> torch.Tensor:
    """``[P, N, N]`` bool: the pairs j > i of rotated problems whose plain BEV
    IoU lies within ``tol`` of the problem's threshold, the only bits where a
    check lets N1's words differ from ``suppression_words_plain``'s."""
    P, N, _ = geom.shape
    near = torch.zeros((P, N, N), dtype=torch.bool, device=geom.device)
    for p in range(P):
        if rotated[p]:
            corners, area = geom[p, :, :8].view(N, 4, 2), geom[p, :, 8]
            near[p] = (iou_corners(corners, area, corners, area) - thr[p]).abs() <= tol
    return near & torch.ones(N, N, dtype=torch.bool, device=geom.device).triu(1)


def greedy_suppress_plain(sup: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The greedy pass on a bool matrix: ``sup [P, N, N]`` in score order (row
    i suppresses column j; j <= i ignored), ``order [P, N]`` the score order
    -> keep ``[P, N]`` bool in the original index order. A loop over score
    rank, as the JAX package's ``lax.fori_loop``."""
    P, N = order.shape
    sup = sup & torch.ones(N, N, dtype=torch.bool, device=sup.device).triu(1)
    keep = torch.ones(P, N, dtype=torch.bool, device=sup.device)
    for i in range(N):
        keep &= ~(sup[:, i] & keep[:, i:i + 1])
    return torch.zeros_like(keep).scatter_(1, order, keep)


def greedy_suppress_words_plain(words: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of N2: the words unpacked, then
    ``greedy_suppress_plain``."""
    return greedy_suppress_plain(unpack_words(words, order.shape[1]), order)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = native.load_library("nms")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bevf_suppression_words.argtypes = [vp, vp, vp, vp, i32, i32, vp]
    lib.bevf_greedy_suppress_words.argtypes = [vp, vp, vp, i32, i32, vp]
    for fn in (lib.bevf_suppression_words, lib.bevf_greedy_suppress_words):
        fn.restype = i32
    return lib.bevf_suppression_words, lib.bevf_greedy_suppress_words


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _kernel_fns()


def _check(name: str, tensors, device) -> None:
    """Each of ``tensors`` ({label: (tensor, dtype, shape)}) contiguous, of
    its dtype and shape, on ``device``; else raise."""
    for label, (t, dtype, shape) in tensors.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {dtype} {tuple(shape)} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}")


def _check_n(name: str, n: int) -> None:
    if n > MAX_N:
        raise ValueError(f"{name}: N {n} > {MAX_N}")


def _launch_words(geom: torch.Tensor, rotated: torch.Tensor, thr: torch.Tensor):
    """Check N1's operands, allocate the words and launch N1 on the current
    stream; returns (words, whether it launched: an empty problem launches
    nothing)."""
    if geom.dim() != 3:
        raise ValueError(f"suppression_words: want geom [P, N, {GEOM}], got {tuple(geom.shape)}")
    P, N = geom.shape[:2]
    _check("suppression_words", {"geom": (geom, torch.float32, (P, N, GEOM)),
                                 "rotated": (rotated, torch.bool, (P,)),
                                 "thr": (thr, torch.float32, (P,))}, geom.device)
    _check_n("suppression_words", N)
    if P > 65535:
        raise ValueError(f"suppression_words: {P} problems > 65535")
    words = torch.empty((P, N, words_count(N)), dtype=torch.int64, device=geom.device)
    if P == 0 or N == 0:
        return words, False
    with torch.cuda.device(geom.device):
        rc = _kernel_fns()[0](geom.data_ptr(), rotated.data_ptr(), thr.data_ptr(),
                              words.data_ptr(), P, N, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"suppression_words: kernel launch failed with cudaError {rc}")
    return words, True


def _launch_greedy(words: torch.Tensor, order: torch.Tensor):
    """Check N2's operands, allocate keep and launch N2 on the current
    stream; returns (keep, whether it launched)."""
    if order.dim() != 2:
        raise ValueError(f"greedy_suppress_words: want order [P, N], got {tuple(order.shape)}")
    P, N = order.shape
    _check("greedy_suppress_words", {"words": (words, torch.int64, (P, N, words_count(N))),
                                     "order": (order, torch.int64, (P, N))}, words.device)
    _check_n("greedy_suppress_words", N)
    keep = torch.empty((P, N), dtype=torch.bool, device=words.device)  # N2 writes every entry
    if P == 0 or N == 0:
        return keep, False
    with torch.cuda.device(words.device):
        rc = _kernel_fns()[1](words.data_ptr(), order.data_ptr(), keep.data_ptr(), P, N,
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"greedy_suppress_words: kernel launch failed with cudaError {rc}")
    return keep, True


def suppression_words(geom: torch.Tensor, rotated: torch.Tensor,
                      thr: torch.Tensor) -> torch.Tensor:
    """N1: words ``[P, N, ceil(N / 64)]`` int64 of ``suppression_words_plain``.

    The op ``bevfusion::suppression_words`` (``ops/library.py``): CUDA tensors
    launch the hand-written kernel (every problem in one launch; a 64 x 64
    tile of pairs a block) on the current stream; CPU tensors take the plain
    version. ``suppression_words.launches`` counts kernel launches."""
    return torch.ops.bevfusion.suppression_words(geom, rotated, thr)


def greedy_suppress_words(words: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """N2: keep ``[P, N]`` bool in the original index order from the words
    ``[P, N, ceil(N / 64)]`` (int64, score order; bits j <= i ignored) and
    the score ``order [P, N]`` (int64, a permutation per problem).

    The op ``bevfusion::greedy_suppress_words`` (``ops/library.py``): CUDA
    tensors launch the hand-written kernel (one warp a problem) on the
    current stream; CPU tensors take ``greedy_suppress_words_plain``. Bits
    in, bits out: both give the same keep mask.
    ``greedy_suppress_words.launches`` counts kernel launches."""
    return torch.ops.bevfusion.greedy_suppress_words(words, order)


suppression_words.launches = 0
greedy_suppress_words.launches = 0


def greedy_suppress(sup: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The greedy pass on a bool matrix ``sup [P, N, N]`` (score order; row i
    suppresses column j > i) and the score ``order [P, N]``: keep ``[P, N]``
    bool in the original index order. The matrix packed into words
    (``pack_words``, tensor ops), then N2."""
    return greedy_suppress_words(pack_words(sup), order)


def _sorted(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(rows, 1, order[..., None].expand(-1, -1, rows.shape[-1])).contiguous()


def _problems(value, P: int, dtype, device) -> torch.Tensor:
    return torch.full((P,), value, dtype=dtype, device=device)


def circle_suppression(centers: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                       radius_sq: float):
    """Circle NMS's input to the greedy pass: centers ``[P, N, 2]``, scores
    and valid ``[P, N]`` -> (N1's words in score order: the squared center
    distance within ``radius_sq``, the score order)."""
    order = score_order(scores, valid)
    P, dev = order.shape[0], order.device
    return suppression_words(_sorted(center_geometry(centers), order),
                             _problems(False, P, torch.bool, dev),
                             _problems(radius_sq, P, torch.float32, dev)), order


def bev_suppression(boxes_bev: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float):
    """Rotated BEV NMS's input to the greedy pass (nms_gpu's rule):
    ``boxes_bev [P, N, 5]`` = (cx, cy, dx, dy, yaw) -> (N1's words in score
    order: the BEV IoU above ``iou_threshold``, the score order)."""
    order = score_order(scores, valid)
    P, dev = order.shape[0], order.device
    return suppression_words(_sorted(box_geometry(boxes_bev), order),
                             _problems(True, P, torch.bool, dev),
                             _problems(iou_threshold, P, torch.float32, dev)), order


def circle_nms_mask(centers: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    radius_sq: float) -> torch.Tensor:
    """A detection is suppressed by a higher-scoring kept one whose center
    is within ``sqrt(radius_sq)``. Returns keep ``[P, N]``."""
    return greedy_suppress_words(*circle_suppression(centers, scores, valid, radius_sq)) & valid


def nms_bev_mask(boxes_bev: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """A detection is suppressed by a higher-scoring kept one whose BEV IoU
    with it exceeds ``iou_threshold``. Returns keep ``[P, N]``."""
    return greedy_suppress_words(*bev_suppression(boxes_bev, scores, valid, iou_threshold)) \
        & valid


def box3d_multiclass_nms_mask(boxes_bev: torch.Tensor, scores: torch.Tensor,
                              valid: torch.Tensor, score_thr: float, iou_threshold: float,
                              max_num=None) -> torch.Tensor:
    """Rotated BEV NMS per class: boxes_bev ``[N, 5]``, scores ``[N, classes]``
    (no background column), valid ``[N]``. A (box, class) pair takes part
    where the box is valid and its class score is above ``score_thr``.
    Returns keep ``[N, classes]``; with ``max_num`` only the ``max_num``
    highest-scoring kept pairs stay (equal scores in the flat
    ``[N * classes]`` order, as the JAX double ``argsort``)."""
    N, C = scores.shape
    m = (valid[:, None] & (scores > score_thr)).t().contiguous()
    keep = nms_bev_mask(boxes_bev[None].expand(C, N, 5).contiguous(),
                        scores.t().contiguous(), m, iou_threshold).t()
    if max_num is not None:
        flat = torch.where(keep, scores, float("-inf")).reshape(-1)
        order = torch.sort(-flat, stable=True).indices
        rank = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                       device=order.device))
        keep = keep & (rank.view(N, C) < max_num)
    return keep


def aligned_3d_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                        valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Axis-aligned 3D IoU NMS within each class: boxes ``[N, 6]`` = (x1, y1,
    z1, x2, y2, z2), scores, classes, valid ``[N]``; a detection is
    suppressed by a higher-scoring kept one of its class whose 3D IoU with
    it exceeds ``thresh``. Returns keep ``[N]``."""
    order = score_order(scores[None], valid[None])[0]
    b, cls = boxes[order], classes[order]
    mins = torch.maximum(b[:, None, :3], b[None, :, :3])
    maxs = torch.minimum(b[:, None, 3:], b[None, :, 3:])
    inter = (maxs - mins).clamp(min=0.0).prod(-1)
    vol = (b[:, 3:] - b[:, :3]).clamp(min=0.0).prod(-1)
    iou = inter / (vol[:, None] + vol[None] - inter).clamp(min=1e-6)
    sup = (iou > thresh) & (cls[:, None] == cls[None])
    return greedy_suppress(sup[None], order[None])[0] & valid
