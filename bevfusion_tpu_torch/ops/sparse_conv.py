"""Sparse 3D convolution: rulebooks over sorted site ids, the gather-GEMM
kernel (``csrc/sparse_conv.cu``: a ``cp.async`` ring feeding 3xTF32
tensor-core tiles), the weight-gradient kernel
(``csrc/sparse_conv_dw.cu``), each with its plain version and a bf16 form
(bf16 rows and one bf16 tensor-core product a step, fp32 sums: the TPU
kernels' own precision), and the autograd Function that trains through
both. The wrappers call the kernels as the ``bevfusion::`` custom ops of
``ops/library.py``, which launch them and count the launches.

Counterpart of ``bevfusion_tpu/ops/sparse_conv.py`` (the rulebook
subset the encoder runs) and of the windowed Pallas kernels of
``bevfusion_tpu/ops/sparse_conv_windowed.py``.

Active sites are sorted linearized ids ``[cap]``, x-major
``(x*Y + y)*Z + z``, padded with ``grid.size``; the voxelizer emits this
order. A neighbor table ``nbr [K, cap_out]`` (offset-major, int32) holds
for each kernel offset the row of the input site each output site reads,
or -1. Because the ids are sorted and unique, one ``torch.searchsorted``
per offset finds the same row as the JAX package's column-bitmask
lookup, so the tables are equal bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native

__all__ = [
    "SparseGrid", "kernel_offsets", "lin_ids", "unlin_ids", "conv_out_shape",
    "build_subm_rulebook", "downsample_sites", "build_conv_rulebook",
    "to_dense", "to_dense_zmajor", "occupancy_zmajor",
    "build_conv_transpose_rulebook", "sparse_conv", "sparse_conv_bf16", "sparse_conv_plain",
    "sparse_inverse_conv_gemm", "sparse_maxpool",
    "sparse_conv_dw", "sparse_conv_dw_bf16", "sparse_conv_dw_plain", "SparseConvFunction",
]


class SparseGrid(NamedTuple):
    X: int
    Y: int
    Z: int

    @property
    def size(self) -> int:
        return self.X * self.Y * self.Z


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def kernel_offsets(kernel_size) -> np.ndarray:
    """Offsets [K, 3] in weight order (x-major, z-minor): index k of the
    ``[K, Cin, Cout]`` weight."""
    kx, ky, kz = _triple(kernel_size)
    return np.array(list(itertools.product(range(kx), range(ky), range(kz))), np.int64)


def lin_ids(coords: torch.Tensor, grid: SparseGrid, valid: Optional[torch.Tensor] = None):
    """(x, y, z) int coords [..., 3] -> x-major ids; invalid -> grid.size."""
    c = coords.long()
    ids = (c[..., 0] * grid.Y + c[..., 1]) * grid.Z + c[..., 2]
    if valid is not None:
        ids = torch.where(valid, ids, grid.size)
    return ids.int()


def unlin_ids(ids: torch.Tensor, grid: SparseGrid):
    ids = ids.long()
    return ids // (grid.Y * grid.Z), (ids // grid.Z) % grid.Y, ids % grid.Z


def conv_out_shape(grid: SparseGrid, kernel_size, stride, padding) -> SparseGrid:
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    return SparseGrid(*[(d + 2 * p[i] - k[i]) // s[i] + 1
                        for i, d in enumerate((grid.X, grid.Y, grid.Z))])


def _offsets(kernel_size, device) -> torch.Tensor:
    return torch.as_tensor(kernel_offsets(kernel_size), device=device)


def _lookup(ids: torch.Tensor, grid: SparseGrid, x, y, z, ok) -> torch.Tensor:
    """Row of site (x, y, z) in the sorted ids, or -1 (any shape)."""
    ok = ok & (x >= 0) & (x < grid.X) & (y >= 0) & (y < grid.Y) & (z >= 0) & (z < grid.Z)
    want = torch.where(ok, (x * grid.Y + y) * grid.Z + z, grid.size)
    ids = ids.long()
    pos = torch.searchsorted(ids, want.reshape(-1)).clamp_(max=ids.numel() - 1)
    pos = pos.reshape(want.shape)
    hit = ok & (ids[pos] == want)
    return torch.where(hit, pos, -1).int()


def build_subm_rulebook(ids: torch.Tensor, grid: SparseGrid, kernel_size=3) -> torch.Tensor:
    """Submanifold neighbor table [K, cap] (``build_subm_rulebook`` with
    ``offset_major=True``): output sites are the input sites."""
    k = _triple(kernel_size)
    off = _offsets(k, ids.device) - torch.as_tensor([(d - 1) // 2 for d in k],
                                                    device=ids.device)
    x, y, z = unlin_ids(ids, grid)
    return _lookup(ids, grid, x[None] + off[:, 0:1], y[None] + off[:, 1:2],
                   z[None] + off[:, 2:3], (ids < grid.size)[None])


def _sorted_unique(ids: torch.Tensor, cap: int, sentinel: int):
    """Sorted unique ids below ``sentinel`` compacted into [cap] (+mask);
    when there are more than ``cap`` the smallest survive."""
    ids_s = torch.sort(ids).values
    head = torch.ones_like(ids_s, dtype=torch.bool)
    head[1:] = ids_s[1:] != ids_s[:-1]
    rank = torch.cumsum(head, 0) - 1
    ok = head & (ids_s < sentinel) & (rank < cap)
    out = torch.full((cap + 1,), sentinel, dtype=ids_s.dtype, device=ids.device)
    out.scatter_(0, torch.where(ok, rank, cap), ids_s)  # index cap = dump slot
    out = out[:cap].int()
    return out, out < sentinel


def downsample_sites(ids: torch.Tensor, grid: SparseGrid, kernel_size, stride, padding,
                     cap_out: int):
    """Active output sites of a strided sparse conv: every output coord
    whose receptive field holds an input site. Returns (out_ids [cap_out]
    sorted, out_mask) on the grid ``conv_out_shape(grid, k, s, p)``."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    og = conv_out_shape(grid, k, s, p)
    coords = unlin_ids(ids, grid)

    def axis_cands(c, ki, si, pi, dim_out):
        """Candidate output coords per input coord on one axis: [cap, n]."""
        outs, oks = [], []
        for t in range(-(-ki // si)):
            off = torch.remainder(c + pi, si) + t * si
            o = torch.div(c + pi - off, si, rounding_mode="floor")
            outs.append(o)
            oks.append((off < ki) & (o >= 0) & (o < dim_out))
        return torch.stack(outs, -1), torch.stack(oks, -1)

    (ox, okx), (oy, oky), (oz, okz) = (
        axis_cands(c, k[i], s[i], p[i], d)
        for i, (c, d) in enumerate(zip(coords, (og.X, og.Y, og.Z))))
    o_id = (ox[:, :, None, None] * og.Y + oy[:, None, :, None]) * og.Z + oz[:, None, None, :]
    ok = (okx[:, :, None, None] & oky[:, None, :, None] & okz[:, None, None, :]
          & (ids < grid.size)[:, None, None, None])
    return _sorted_unique(torch.where(ok, o_id, og.size).reshape(-1), cap_out, og.size)


def build_conv_rulebook(in_ids: torch.Tensor, out_ids: torch.Tensor, grid: SparseGrid,
                        out_grid: SparseGrid, kernel_size, stride, padding) -> torch.Tensor:
    """Strided-conv gather table [K, cap_out] (``build_conv_rulebook``
    with ``offset_major=True``): output site o reads input o*s - p + off_k."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    off = _offsets(k, out_ids.device)
    ox, oy, oz = unlin_ids(out_ids, out_grid)
    return _lookup(in_ids, grid,
                   ox[None] * s[0] - p[0] + off[:, 0:1],
                   oy[None] * s[1] - p[1] + off[:, 1:2],
                   oz[None] * s[2] - p[2] + off[:, 2:3],
                   (out_ids < out_grid.size)[None])


def build_conv_transpose_rulebook(in_ids: torch.Tensor, out_ids: torch.Tensor,
                                  grid: SparseGrid, out_grid: SparseGrid, kernel_size, stride,
                                  padding) -> torch.Tensor:
    """Transposed table [K, cap_in] of a strided sparse conv
    (``build_conv_transpose_rulebook`` with ``offset_major=True``): for
    input site i and offset k the output site o with o*s - p + off_k == i,
    or -1. If ``nbr[k, o] == i`` then ``nbr_t[k, i] == o``, so the conv of
    ``dout`` over ``nbr_t`` with ``W_k^T`` is the gradient of the input."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    off = _offsets(k, in_ids.device)
    coords = unlin_ids(in_ids, grid)
    n = [c[None] + p[a] - off[:, a:a + 1] for a, c in enumerate(coords)]  # o * s per axis
    ok = (in_ids < grid.size)[None]
    for a in range(3):
        ok = ok & (torch.remainder(n[a], s[a]) == 0)
    ox, oy, oz = (torch.div(n[a], s[a], rounding_mode="floor") for a in range(3))
    return _lookup(out_ids, out_grid, ox, oy, oz, ok)


def _scatter_rows(rows: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, size: int):
    """dense[idx[i]] = rows[i] for masked i, over ``size`` zero rows."""
    dense = rows.new_zeros((size + 1,) + rows.shape[1:])
    dense[torch.where(mask, idx, size)] = rows  # row ``size`` takes the padding
    return dense[:size]


def to_dense(feats: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, grid: SparseGrid):
    """Active features scattered into a dense [X, Y, Z, C] grid."""
    dense = _scatter_rows(feats, ids.long(), mask, grid.size)
    return dense.view(grid.X, grid.Y, grid.Z, feats.shape[-1])


def _zmajor(ids: torch.Tensor, grid: SparseGrid) -> torch.Tensor:
    ids = ids.long()
    return (ids % grid.Z) * (grid.X * grid.Y) + ids // grid.Z


def to_dense_zmajor(feats: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                    grid: SparseGrid):
    """Active features scattered into a dense z-major [Z, X, Y, C] grid."""
    dense = _scatter_rows(feats, _zmajor(ids, grid), mask, grid.size)
    return dense.view(grid.Z, grid.X, grid.Y, feats.shape[-1])


def occupancy_zmajor(ids: torch.Tensor, mask: torch.Tensor, grid: SparseGrid):
    """Dense z-major [Z, X, Y] bool occupancy."""
    ones = torch.ones_like(mask)
    return _scatter_rows(ones, _zmajor(ids, grid), mask, grid.size).view(grid.Z, grid.X, grid.Y)


# ----------------------------------------------------------------------
# the gather-GEMM conv: CUDA kernel and plain version
# ----------------------------------------------------------------------

def _epilogue(y, scale, shift, residual, relu: bool):
    if scale is not None:
        y = y * scale
    if shift is not None:
        y = y + shift
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def sparse_conv_plain(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                      scale=None, shift=None, residual=None, relu: bool = False):
    """Plain PyTorch version of the kernel (``subm_gather_gemm`` plus the
    windowed kernels' eval epilogue): one gather of all K neighbor rows of
    every output site, misses zeroed, then one
    ``[cap_out, K*Cin] @ [K*Cin, Cout]`` matmul, then
    ``relu(y*scale + shift + residual)``, each part optional. In bf16
    (``feats``, ``weight``, ``residual`` bf16; ``scale``, ``shift`` fp32) the
    bf16 kernel's contract: the product and the epilogue in fp32, rounded
    once to bf16. Never under autocast."""
    out_dtype = feats.dtype
    if out_dtype == torch.bfloat16:
        feats, weight = feats.float(), weight.float()
        residual = None if residual is None else residual.float()
    K, Cin, Cout = weight.shape
    nbr_sm = nbr.t().reshape(-1)  # site-major [cap_out*K]
    with torch.autocast(feats.device.type, enabled=False):
        g = feats.index_select(0, nbr_sm.clamp(min=0))
        g = torch.where((nbr_sm >= 0)[:, None], g, 0.0)
        y = g.reshape(-1, K * Cin) @ weight.reshape(K * Cin, Cout)
        return _epilogue(y, scale, shift, residual, relu).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = native.load_library("sparse_conv").bevf_sparse_conv_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [i32] * 6 + [vp]
    fn.restype = i32
    return fn


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _kernel_fn()
    _bf16_kernel_fn()


def _check_cuda_args(what: str, feats, nbr, K: int, Cin: int, Cout: int,
                     dtype=torch.float32, **others) -> None:
    """Raise unless ``feats [cap_in, Cin]`` and every tensor of ``others``
    (name -> (tensor or None, wanted shape)) are contiguous ``dtype`` (fp32
    or bf16; ``scale`` and ``shift`` fp32 in either) and ``nbr [K,
    cap_out]`` is contiguous int32, all on feats' device, with 1..128
    channels in and out."""
    named = {"feats": (feats, (feats.shape[0], Cin) if feats.dim() == 2 else (-1, Cin)),
             "nbr": (nbr, (K, nbr.shape[-1]) if nbr.dim() == 2 else (K, -1)), **others}
    for name, (t, shape) in named.items():
        if t is None:
            continue
        if t.device != feats.device:
            raise ValueError(f"{what}: {name} is on {t.device}, feats on {feats.device}")
        want = {"nbr": torch.int32, "scale": torch.float32, "shift": torch.float32}.get(name, dtype)
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, want {tuple(shape)}")
    if not (1 <= Cin <= 128 and 1 <= Cout <= 128):
        raise ValueError(f"{what}: the kernel takes 1..128 channels, got {Cin}->{Cout}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_conv(what: str, fn, dtype, feats, nbr, weight, scale, shift, residual, relu):
    """Check the operands of a forward kernel (``dtype`` throughout,
    ``scale``/``shift`` fp32), allocate ``out`` and launch ``fn`` on the
    current stream; returns out."""
    if weight.dim() != 3:
        raise ValueError(f"{what}: weight must be [K, Cin, Cout], got {tuple(weight.shape)}")
    K, Cin, Cout = weight.shape
    cap_out = nbr.shape[-1]
    _check_cuda_args(what, feats, nbr, K, Cin, Cout, dtype, weight=(weight, (K, Cin, Cout)),
                     scale=(scale, (Cout,)), shift=(shift, (Cout,)),
                     residual=(residual, (cap_out, Cout)))
    out = torch.empty((cap_out, Cout), dtype=dtype, device=feats.device)
    if cap_out == 0:
        return out
    with torch.cuda.device(feats.device):
        rc = fn()(_ptr(feats), _ptr(nbr), _ptr(weight), _ptr(scale), _ptr(shift),
                  _ptr(residual), _ptr(out), feats.shape[0], cap_out, K, Cin, Cout,
                  int(relu), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {rc}")
    return out


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                scale=None, shift=None, residual=None, relu: bool = False) -> torch.Tensor:
    """``out [cap_out, Cout] = relu(sum_k feats[nbr[k]] @ weight[k] * scale
    + shift + residual)`` (each epilogue part optional; nbr -1 = miss).

    The op ``bevfusion::sparse_conv`` (``ops/library.py``), or
    ``bevfusion::sparse_conv_bf16`` for bf16 rows: CUDA tensors launch the
    hand-written kernel on the current stream, fp32 operands the 3xTF32
    kernel, bf16 ones (``scale``, ``shift`` fp32) its bf16 form; contiguous
    inputs, Cin, Cout <= 128. CPU tensors take ``sparse_conv_plain``.
    ``sparse_conv.launches`` counts the fp32 kernel's launches,
    ``sparse_conv_bf16.launches`` the bf16 one's.
    """
    op = torch.ops.bevfusion.sparse_conv_bf16 if feats.dtype == torch.bfloat16 \
        else torch.ops.bevfusion.sparse_conv
    return op(feats, nbr, weight, scale, shift, residual, relu)


def sparse_inverse_conv_gemm(feats: torch.Tensor, nbr_t: torch.Tensor,
                             weight: torch.Tensor) -> torch.Tensor:
    """Inverse ("deconv") sparse conv (reference SparseInverseConv3d,
    ops/spconv/conv.py:181-223): the output sites are the paired strided
    conv's *input* sites, and each (input i, output o, offset k) pair of
    its rulebook adds ``feats[o] @ weight[k]`` to ``out[i]``. ``nbr_t [K,
    cap_in]`` is that conv's transposed table
    (``build_conv_transpose_rulebook``: the same pairs, the same k, as the
    reference replays its indice pairs with gather and scatter swapped),
    so this is the gather-GEMM ``sparse_conv(feats, nbr_t, weight)``: on
    CUDA tensors the hand kernel (K1/K2), counted in
    ``sparse_conv.launches``. Counterpart of the JAX
    ``sparse_inverse_conv_gemm`` (its table ``[cap_in, K]``, here the
    port's offset-major ``[K, cap_in]``)."""
    return sparse_conv(feats, nbr_t, weight)


def sparse_maxpool(feats: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """indice_maxpool (reference ops/spconv/pool.py:21): ``out[o]`` is the
    elementwise max of ``feats[i]`` over the present neighbours ``i =
    nbr[k, o]`` (misses, -1, ignored; a row with none is 0). feats
    ``[cap_in, C]``, nbr ``[K, cap_out]`` (offset-major) -> ``[cap_out, C]``.
    Plain PyTorch (one gather and a max): the JAX package has no kernel
    for it either."""
    hit = nbr >= 0
    g = feats.index_select(0, nbr.clamp(min=0).reshape(-1)).view(*nbr.shape, -1)
    out = torch.where(hit[..., None], g, float("-inf")).amax(0)
    return torch.where(hit.any(0)[:, None], out, 0.0).to(feats.dtype)


@functools.lru_cache(maxsize=None)
def _bf16_kernel_fn():
    fn = native.load_library("sparse_conv").bevf_sparse_conv_bf16
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [i32] * 6 + [vp]
    fn.restype = i32
    return fn


def sparse_conv_bf16(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                     scale=None, shift=None, residual=None, relu: bool = False) -> torch.Tensor:
    """The bf16 form of ``sparse_conv`` on CUDA tensors (the op
    ``bevfusion::sparse_conv_bf16``): ``feats``, ``weight``, ``residual``
    and ``out`` bf16, ``scale`` / ``shift`` fp32; one bf16 tensor-core
    product a 16-deep step with fp32 sums, the epilogue in fp32, one
    rounding to bf16 (``sparse_conv_plain``'s bf16 contract).
    ``sparse_conv_bf16.launches`` counts its launches."""
    if feats.device.type != "cuda":
        raise ValueError(f"sparse_conv_bf16: feats on {feats.device}, not a CUDA device")
    return torch.ops.bevfusion.sparse_conv_bf16(feats, nbr, weight, scale, shift, residual, relu)


sparse_conv_bf16.launches = 0
sparse_conv.launches = 0

# the keys of the bf16 kernel's launch plan (csrc/sparse_conv_bf16_tile.cuh:run_bf16)
BF16_PLAN_KEYS = ("blocks_per_sm", "registers", "spill_bytes", "smem_bytes", "stages", "ahead",
                  "threads", "grid", "slabs")


def sparse_conv_bf16_plan(cap_out: int, num_offsets: int, cin: int, cout: int) -> dict:
    """What ``sparse_conv_bf16`` launches for these sizes on the current card
    (``BF16_PLAN_KEYS``: resident blocks an SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, registers and spilled
    bytes a thread from ``cudaFuncGetAttributes``, dynamic shared memory a
    block, ring stages, offsets staged ahead of the one multiplied, threads a
    block, blocks in the grid, 16-row slabs a warp); launches nothing."""
    fn = native.load_library("sparse_conv").bevf_sparse_conv_bf16_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(BF16_PLAN_KEYS))()
    rc = fn(cap_out, num_offsets, cin, cout, ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"sparse_conv_bf16_plan: cudaError {rc}")
    return dict(zip(BF16_PLAN_KEYS, info))


# ----------------------------------------------------------------------
# the weight gradient: CUDA kernel and plain version
# ----------------------------------------------------------------------

# output sites per block of the weight-gradient kernel: at the encoder's
# caps (60,000-160,000 sites) 30-79 chunks x 27 offsets, more blocks than
# the 132 SMs hold at once, and a 16 KB hit list in shared memory
DW_CHUNK = 2048


def sparse_conv_dw_plain(feats: torch.Tensor, nbr: torch.Tensor,
                         dout: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: the gradient of
    ``sparse_conv_plain`` (``subm_gather_gemm``) with respect to its weight.
    One gather ``[cap_out, K*Cin]`` of every output site's neighbor rows,
    misses zeroed, then ``g^T @ dout`` folded to ``[K, Cin, Cout]``. bf16
    ``feats`` and ``dout`` give an fp32 dW (the products exact, fp32 sums),
    as the bf16 kernel. Never under autocast."""
    if feats.dtype == torch.bfloat16:
        feats, dout = feats.float(), dout.float()
    K, cap_out = nbr.shape
    Cin = feats.shape[1]
    nbr_sm = nbr.t().reshape(-1)
    with torch.autocast(feats.device.type, enabled=False):
        g = feats.index_select(0, nbr_sm.clamp(min=0))
        g = torch.where((nbr_sm >= 0)[:, None], g, 0.0).reshape(cap_out, K * Cin)
        return (g.t() @ dout).reshape(K, Cin, dout.shape[1])


@functools.lru_cache(maxsize=None)
def _dw_kernel_fn():
    fn = native.load_library("sparse_conv_dw").bevf_sparse_conv_dw_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [i32] * 6 + [vp]
    fn.restype = i32
    return fn


def build_dw_kernels() -> None:
    """Compile and load the weight-gradient library (done anyway at first launch)."""
    _dw_kernel_fn()
    _dw_bf16_kernel_fn()


def _launch_dw(what: str, fn, dtype, feats, nbr, dout) -> torch.Tensor:
    """Check the operands of a weight-gradient kernel (``dtype``),
    allocate dW and the partial scratch (fp32) and launch ``fn``'s two
    passes on the current stream; returns dW."""
    K, cap_out, Cin, Cout = nbr.shape[0], nbr.shape[-1], feats.shape[-1], dout.shape[-1]
    _check_cuda_args(what, feats, nbr, K, Cin, Cout, dtype, dout=(dout, (cap_out, Cout)))
    dw = torch.empty((K, Cin, Cout), dtype=torch.float32, device=feats.device)
    if cap_out == 0:
        return dw.zero_()
    chunks = -(-cap_out // DW_CHUNK)
    partial = torch.empty((chunks, K, Cin, Cout), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = fn()(_ptr(feats), _ptr(nbr), _ptr(dout), _ptr(partial), _ptr(dw), feats.shape[0],
                  cap_out, K, Cin, Cout, DW_CHUNK, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {rc}")
    return dw


def sparse_conv_dw(feats: torch.Tensor, nbr: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``dW [K, Cin, Cout]``, ``dW[k] = sum_o feats[nbr[k, o]]^T dout[o]``
    over the output sites o that hit (nbr -1 = miss): the weight gradient
    of ``sparse_conv``.

    The op ``bevfusion::sparse_conv_dw``, or ``bevfusion::sparse_conv_dw_bf16``
    for bf16 ``feats`` and ``dout`` (fp32 dW): CUDA tensors launch the
    hand-written kernel (contiguous inputs; Cin, Cout <= 128; the hit pairs
    compacted per offset and chunk and multiplied on the tensor cores, in
    the 3xTF32 split at fp32) on the current stream, with a fixed-order
    reduction over its warps and site chunks, so the result is the same
    from run to run. CPU tensors take ``sparse_conv_dw_plain``.
    ``sparse_conv_dw.launches`` counts the fp32 kernel's launches,
    ``sparse_conv_dw_bf16.launches`` the bf16 one's.
    """
    op = torch.ops.bevfusion.sparse_conv_dw_bf16 if feats.dtype == torch.bfloat16 \
        else torch.ops.bevfusion.sparse_conv_dw
    return op(feats, nbr, dout)


@functools.lru_cache(maxsize=None)
def _dw_bf16_kernel_fn():
    fn = native.load_library("sparse_conv_dw").bevf_sparse_conv_dw_bf16
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [i32] * 6 + [vp]
    fn.restype = i32
    return fn


def sparse_conv_dw_bf16(feats: torch.Tensor, nbr: torch.Tensor,
                        dout: torch.Tensor) -> torch.Tensor:
    """The bf16 form of ``sparse_conv_dw`` on CUDA tensors (the op
    ``bevfusion::sparse_conv_dw_bf16``): bf16 ``feats`` and ``dout``, fp32
    dW; one bf16 tensor-core product (exact in fp32) a 16-site step, fp32
    sums in the fp32 form's fixed order. ``sparse_conv_dw_bf16.launches``
    counts its launches."""
    if feats.device.type != "cuda":
        raise ValueError(f"sparse_conv_dw_bf16: feats on {feats.device}, not a CUDA device")
    return torch.ops.bevfusion.sparse_conv_dw_bf16(feats, nbr, dout)


sparse_conv_dw_bf16.launches = 0
sparse_conv_dw.launches = 0


class SparseConvFunction(torch.autograd.Function):
    """Differentiable sparse conv: ``sparse_conv(feats, nbr, weight)`` with
    no epilogue (training BatchNorm needs the batch moments, so it runs
    apart). Counterpart of ``windowed_conv_ad`` (the JAX package's custom
    VJP, the reference's spconv indiceConvBackward):

    - backward-data of a submanifold conv (``nbr_t`` None): the forward
      kernel on ``dout`` over the same ``nbr`` with the offset-mirrored,
      transposed weight ``W[::-1].transpose(1, 2)`` (pair (o, k) = i is
      pair (i, K-1-k) = o);
    - backward-data of a strided conv: the forward kernel on ``dout`` over
      the transposed rulebook ``nbr_t [K, cap_in]``
      (``build_conv_transpose_rulebook``) with ``W.transpose(1, 2)``;
    - backward-weight: ``sparse_conv_dw``.

    No backward-data runs when ``feats`` needs no gradient (the voxel
    features into the input conv). On CUDA tensors every part launches a
    kernel; on CPU tensors the plain versions. In bf16 (``feats`` bf16,
    ``weight`` the fp32 parameter) the weight is cast to bf16 here, inside
    the Function, and the weight gradient is the bf16 kernel's fp32 dW: a
    cast outside would round that dW to bf16 in its own backward.
    """

    @staticmethod
    def forward(ctx, feats, weight, nbr, nbr_t=None):
        w = weight.to(feats.dtype)
        ctx.save_for_backward(feats, w, nbr, nbr_t)
        return sparse_conv(feats, nbr, w)

    @staticmethod
    def backward(ctx, dout):
        feats, weight, nbr, nbr_t = ctx.saved_tensors
        dout = dout.contiguous()
        d_feats = d_weight = None
        if ctx.needs_input_grad[0]:
            if nbr_t is None:
                d_feats = sparse_conv(dout, nbr, weight.flip(0).transpose(1, 2).contiguous())
            else:
                d_feats = sparse_conv(dout, nbr_t, weight.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            d_weight = sparse_conv_dw(feats, nbr, dout)
        return d_feats, d_weight, None, None
