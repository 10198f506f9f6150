"""The hand kernels as ``torch.library`` custom ops, namespace ``bevfusion``.

One op a kernel, each with three implementations:

- ``cuda``: checks the operands (the module's ``_check_cuda_args``),
  launches the hand kernel through its ctypes entry on the current stream
  and adds one to its wrapper's ``.launches`` counter (only here, and only
  when a kernel ran). A kernel that fails to build or launch raises; the
  op never hands a CUDA call to the plain version;
- ``cpu``: the module's plain PyTorch version;
- fake (shape only): the output's shape and dtype, so ``torch.export``,
  ``torch.compile`` and CUDA-graph capture see each kernel as one node.

=======================  =====================================  ===============
op                       entry point (wrapper)                  kernel
=======================  =====================================  ===============
``sparse_conv``          ``ops/sparse_conv.py:sparse_conv``     K1/K2 fp32
``sparse_conv_bf16``     ``sparse_conv`` on bf16 rows           K1/K2 bf16
``sparse_conv_dw``       ``sparse_conv_dw``                     K3 fp32
``sparse_conv_dw_bf16``  ``sparse_conv_dw`` on bf16 rows        K3 bf16
``bev_pool``             ``ops/bev_pool.py:bev_pool``           K4
``suppression_words``    ``ops/nms.py:suppression_words``       N1 (NMS words)
``greedy_suppress_       ``ops/nms.py:greedy_suppress_          N2 (NMS greedy
words``                  words``                                pass)
``deform_im2col``        ``ops/deform_conv.py:deform_im2col``   D1
``furthest_point_        ``ops/pointnet.py:furthest_point_      D2
sample``                 sample``
``auction``              ``ops/auction.py:auction_rounds``      the auction
                         (``core/matching.py:auction_           matcher
                         assignment`` counts its launches)
=======================  =====================================  ===============

The wrappers call these ops and nothing else, so eager runs, training
(``SparseConvFunction`` and ``BEVPoolFunction`` call the wrappers in
their forward and backward; the ops carry no autograd formula of their
own) and an exported program go through the same dispatch. The one
exception is ``deform_im2col``, whose gradient (autograd of its plain
version, as the JAX gradient is XLA's) the op registers itself. Importing
``bevfusion_tpu_torch.ops`` registers them, which ``torch.export.load``
of a program that holds them needs first.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import auction as au
from . import bev_pool as bp
from . import deform_conv as dc
from . import nms
from . import pointnet as pn
from . import sparse_conv as sp

__all__ = ["NAMESPACE", "OPS", "COUNTERS", "op_counts"]

NAMESPACE = "bevfusion"
OPS = ("sparse_conv", "sparse_conv_bf16", "sparse_conv_dw", "sparse_conv_dw_bf16", "bev_pool",
       "suppression_words", "greedy_suppress_words", "deform_im2col", "furthest_point_sample",
       "auction")

# the wrappers whose ``.launches`` each op's CUDA implementation counts, by op
COUNTERS = {"sparse_conv": sp.sparse_conv, "sparse_conv_bf16": sp.sparse_conv_bf16,
            "sparse_conv_dw": sp.sparse_conv_dw, "sparse_conv_dw_bf16": sp.sparse_conv_dw_bf16,
            "bev_pool": bp.bev_pool, "suppression_words": nms.suppression_words,
            "greedy_suppress_words": nms.greedy_suppress_words,
            "deform_im2col": dc.deform_im2col, "furthest_point_sample": pn.furthest_point_sample,
            "auction": au.auction_assignment}


def _launched(name: str) -> None:
    COUNTERS[name].launches += 1


# ----------------------------------------------------------------------
# K1/K2: the sparse conv, fp32 and bf16
# ----------------------------------------------------------------------

def _conv_fake(feats, nbr, weight, scale, shift, residual, relu):
    return feats.new_empty((nbr.shape[-1], weight.shape[-1]))


@torch.library.custom_op(f"{NAMESPACE}::sparse_conv", mutates_args=(), device_types="cpu")
def sparse_conv(feats: Tensor, nbr: Tensor, weight: Tensor, scale: Optional[Tensor],
                shift: Optional[Tensor], residual: Optional[Tensor], relu: bool) -> Tensor:
    return sp.sparse_conv_plain(feats, nbr, weight, scale, shift, residual, relu)


@sparse_conv.register_kernel("cuda")
def _(feats, nbr, weight, scale, shift, residual, relu):
    out = sp._launch_conv("sparse_conv", sp._kernel_fn, torch.float32, feats, nbr, weight,
                          scale, shift, residual, relu)
    if out.shape[0]:
        _launched("sparse_conv")
    return out


@torch.library.custom_op(f"{NAMESPACE}::sparse_conv_bf16", mutates_args=(), device_types="cpu")
def sparse_conv_bf16(feats: Tensor, nbr: Tensor, weight: Tensor, scale: Optional[Tensor],
                     shift: Optional[Tensor], residual: Optional[Tensor], relu: bool) -> Tensor:
    return sp.sparse_conv_plain(feats, nbr, weight, scale, shift, residual, relu)


@sparse_conv_bf16.register_kernel("cuda")
def _(feats, nbr, weight, scale, shift, residual, relu):
    out = sp._launch_conv("sparse_conv_bf16", sp._bf16_kernel_fn, torch.bfloat16, feats, nbr,
                          weight, scale, shift, residual, relu)
    if out.shape[0]:
        _launched("sparse_conv_bf16")
    return out


sparse_conv.register_fake(_conv_fake)
sparse_conv_bf16.register_fake(_conv_fake)


# ----------------------------------------------------------------------
# K3: the weight gradient, fp32 and bf16 (fp32 dW from either)
# ----------------------------------------------------------------------

def _dw_fake(feats, nbr, dout):  # an fp32 dW from bf16 rows
    dtype = torch.float32 if feats.dtype == torch.bfloat16 else feats.dtype
    return feats.new_empty((nbr.shape[0], feats.shape[-1], dout.shape[-1]), dtype=dtype)


@torch.library.custom_op(f"{NAMESPACE}::sparse_conv_dw", mutates_args=(), device_types="cpu")
def sparse_conv_dw(feats: Tensor, nbr: Tensor, dout: Tensor) -> Tensor:
    return sp.sparse_conv_dw_plain(feats, nbr, dout)


@sparse_conv_dw.register_kernel("cuda")
def _(feats, nbr, dout):
    dw = sp._launch_dw("sparse_conv_dw", sp._dw_kernel_fn, torch.float32, feats, nbr, dout)
    if nbr.shape[-1]:
        _launched("sparse_conv_dw")
    return dw


@torch.library.custom_op(f"{NAMESPACE}::sparse_conv_dw_bf16", mutates_args=(),
                         device_types="cpu")
def sparse_conv_dw_bf16(feats: Tensor, nbr: Tensor, dout: Tensor) -> Tensor:
    return sp.sparse_conv_dw_plain(feats, nbr, dout)


@sparse_conv_dw_bf16.register_kernel("cuda")
def _(feats, nbr, dout):
    dw = sp._launch_dw("sparse_conv_dw_bf16", sp._dw_bf16_kernel_fn, torch.bfloat16, feats, nbr,
                       dout)
    if nbr.shape[-1]:
        _launched("sparse_conv_dw_bf16")
    return dw


sparse_conv_dw.register_fake(_dw_fake)
sparse_conv_dw_bf16.register_fake(_dw_fake)


# ----------------------------------------------------------------------
# K4: the BEV pool (the intervals as five int32 tensors)
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::bev_pool", mutates_args=(), device_types="cpu")
def bev_pool(depth: Tensor, ctx: Tensor, ranks_depth: Tensor, ranks_feat: Tensor,
             interval_starts: Tensor, interval_lengths: Tensor, interval_cells: Tensor,
             Z: int, X: int, Y: int) -> Tensor:
    """The flat grid [B*Z*X*Y, C] (``bev_pool.bev_pool`` views it as NCHW)."""
    iv = bp.PoolIntervals(ranks_depth, ranks_feat, interval_starts, interval_lengths,
                          interval_cells)
    return bp.bev_pool_flat_plain(depth, ctx, iv, depth.shape[0] * Z * X * Y)


@bev_pool.register_kernel("cuda")
def _(depth, ctx, ranks_depth, ranks_feat, interval_starts, interval_lengths, interval_cells,
      Z, X, Y):
    iv = bp.PoolIntervals(ranks_depth, ranks_feat, interval_starts, interval_lengths,
                          interval_cells)
    out, launched = bp._launch_pool(depth, ctx, iv, depth.shape[0] * Z * X * Y)
    if launched:
        _launched("bev_pool")
    return out


@bev_pool.register_fake
def _(depth, ctx, ranks_depth, ranks_feat, interval_starts, interval_lengths, interval_cells,
      Z, X, Y):
    return depth.new_empty((depth.shape[0] * Z * X * Y, ctx.shape[-1]),
                           dtype=torch.promote_types(depth.dtype, ctx.dtype))


# ----------------------------------------------------------------------
# the NMS: N1, the suppression words; N2, the greedy pass on them
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::suppression_words", mutates_args=(), device_types="cpu")
def suppression_words(geom: Tensor, rotated: Tensor, thr: Tensor) -> Tensor:
    return nms.suppression_words_plain(geom, rotated, thr)


@suppression_words.register_kernel("cuda")
def _(geom, rotated, thr):
    words, launched = nms._launch_words(geom, rotated, thr)
    if launched:
        _launched("suppression_words")
    return words


@suppression_words.register_fake
def _(geom, rotated, thr):
    P, N = geom.shape[:2]
    return geom.new_empty((P, N, nms.words_count(N)), dtype=torch.int64)


@torch.library.custom_op(f"{NAMESPACE}::greedy_suppress_words", mutates_args=(),
                         device_types="cpu")
def greedy_suppress_words(words: Tensor, order: Tensor) -> Tensor:
    return nms.greedy_suppress_words_plain(words, order)


@greedy_suppress_words.register_kernel("cuda")
def _(words, order):
    keep, launched = nms._launch_greedy(words, order)
    if launched:
        _launched("greedy_suppress_words")
    return keep


@greedy_suppress_words.register_fake
def _(words, order):
    return order.new_empty(order.shape, dtype=torch.bool)


# ----------------------------------------------------------------------
# D1: the deformable im2col (its gradient: autograd of the plain version)
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::deform_im2col", mutates_args=(), device_types="cpu")
def deform_im2col(x: Tensor, offset: Tensor, mask: Optional[Tensor], kernel_size: int,
                  stride: int, padding: int) -> Tensor:
    return dc.deform_im2col_plain(x, offset, mask, kernel_size, stride, padding)


@deform_im2col.register_kernel("cuda")
def _(x, offset, mask, kernel_size, stride, padding):
    col, launched = dc._launch_im2col(x, offset, mask, kernel_size, stride, padding)
    if launched:
        _launched("deform_im2col")
    return col


@deform_im2col.register_fake
def _(x, offset, mask, kernel_size, stride, padding):
    B, H, W, C = x.shape
    Ho, Wo = (dc._out_size(n, kernel_size, stride, padding) for n in (H, W))
    return x.new_empty((B * Ho * Wo, kernel_size * kernel_size * C))


def _im2col_setup(ctx, inputs, output):
    x, offset, mask, kernel_size, stride, padding = inputs
    ctx.save_for_backward(x, offset, mask)
    ctx.geometry = (kernel_size, stride, padding)


def _im2col_backward(ctx, grad):
    x, offset, mask = ctx.saved_tensors
    wanted = [t.detach().requires_grad_(need) if t is not None else None
              for t, need in zip((x, offset, mask), ctx.needs_input_grad[:3])]
    with torch.enable_grad():
        col = dc.deform_im2col_plain(*wanted, *ctx.geometry)
        leaves = [t for t in wanted if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(col, leaves, grad) if leaves else ())
    return (*(next(grads) if t is not None and t.requires_grad else None for t in wanted),
            None, None, None)


deform_im2col.register_autograd(_im2col_backward, setup_context=_im2col_setup)


# ----------------------------------------------------------------------
# D2: furthest point sampling (indices: no gradient)
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::furthest_point_sample", mutates_args=(),
                         device_types="cpu")
def furthest_point_sample(xyz: Tensor, npoint: int, mask: Optional[Tensor]) -> Tensor:
    return pn.furthest_point_sample_plain(xyz, npoint, mask)


@furthest_point_sample.register_kernel("cuda")
def _(xyz, npoint, mask):
    out, launched = pn._launch_fps(xyz, npoint, mask)
    if launched:
        _launched("furthest_point_sample")
    return out


@furthest_point_sample.register_fake
def _(xyz, npoint, mask):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


# ----------------------------------------------------------------------
# the auction matcher (assignments: no gradient)
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::auction", mutates_args=(), device_types="cpu")
def auction(value: Tensor, row_valid: Tensor, eps: Tensor,
            max_iters: int) -> Tuple[Tensor, Tensor, Tensor]:
    """One problem: value [R, C] fp32, row_valid [R] bool, eps 0-dim fp32 ->
    (assign [R] int64, price [C] fp32, rounds 0-dim int32)."""
    return au.auction_rounds_plain(value, row_valid, eps, max_iters)


@auction.register_kernel("cuda")
def _(value, row_valid, eps, max_iters):
    R, C = value.shape
    (assign, price, rounds), launched = au._launch_auction(
        value.reshape(1, R, C).contiguous(), row_valid.reshape(1, R).contiguous(), eps.reshape(1),
        max_iters)
    if launched:
        _launched("auction")
    return assign[0], price[0], rounds[0]


@auction.register_fake
def _(value, row_valid, eps, max_iters):
    R, C = value.shape
    return (value.new_empty((R,), dtype=torch.int64), value.new_empty((C,)),
            value.new_empty((), dtype=torch.int32))


def op_counts(graph_module: torch.nn.Module) -> dict:
    """``{op name: nodes}`` of the ``bevfusion::`` ops in a traced graph
    module and every submodule it holds (an autocast region of an exported
    program is a submodule of its own)."""
    counts = {name: 0 for name in OPS}
    for mod in graph_module.modules():
        graph = getattr(mod, "graph", None)
        if not isinstance(graph, torch.fx.Graph):
            continue
        for node in graph.nodes:
            target = getattr(node.target, "_schema", None)
            if node.op == "call_function" and target is not None \
                    and target.name.startswith(f"{NAMESPACE}::"):
                counts[target.name.split("::", 1)[1]] += 1
    return counts
