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
``greedy_suppress``      ``ops/nms.py:greedy_suppress``         the NMS pass
=======================  =====================================  ===============

The wrappers call these ops and nothing else, so eager runs, training
(``SparseConvFunction`` and ``BEVPoolFunction`` call the wrappers in
their forward and backward; the ops carry no autograd formula of their
own) and an exported program go through the same dispatch. Importing
``bevfusion_tpu_torch.ops`` registers them, which ``torch.export.load``
of a program that holds them needs first.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import bev_pool as bp
from . import nms
from . import sparse_conv as sp

__all__ = ["NAMESPACE", "OPS", "COUNTERS", "op_counts"]

NAMESPACE = "bevfusion"
OPS = ("sparse_conv", "sparse_conv_bf16", "sparse_conv_dw", "sparse_conv_dw_bf16", "bev_pool",
       "greedy_suppress")

# the wrappers whose ``.launches`` each op's CUDA implementation counts, by op
COUNTERS = {"sparse_conv": sp.sparse_conv, "sparse_conv_bf16": sp.sparse_conv_bf16,
            "sparse_conv_dw": sp.sparse_conv_dw, "sparse_conv_dw_bf16": sp.sparse_conv_dw_bf16,
            "bev_pool": bp.bev_pool, "greedy_suppress": nms.greedy_suppress}


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
# the greedy NMS pass
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::greedy_suppress", mutates_args=(), device_types="cpu")
def greedy_suppress(sup: Tensor, order: Tensor) -> Tensor:
    return nms.greedy_suppress_plain(sup, order)


@greedy_suppress.register_kernel("cuda")
def _(sup, order):
    keep, launched = nms._launch_suppress(sup, order)
    if launched:
        _launched("greedy_suppress")
    return keep


@greedy_suppress.register_fake
def _(sup, order):
    return order.new_empty(order.shape, dtype=torch.bool)


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
