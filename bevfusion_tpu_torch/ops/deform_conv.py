"""Deformable 2D convolution (DCN v1 / v2), with the deformable im2col as a
hand-written kernel (``csrc/deform_conv.cu``, the custom op
``bevfusion::deform_im2col`` of ``ops/library.py``) and its plain version.

Counterpart of ``bevfusion_tpu/ops/deform_conv.py`` (reference mmcv's
``DeformConv2dPack`` as DCNSeparateHead uses it,
mmdet3d/models/heads/bbox/centerpoint.py:130-246): for each output position
and kernel tap the input is sampled bilinearly at the tap's place moved by
its offset (four corners; a corner outside the image contributes 0), times
the tap's modulation mask where there is one, into a column buffer
``[B*Ho*Wo, K*Cin]``; the contraction with the weight is one
``torch.matmul``, as the JAX package leaves it to an ``einsum`` outside any
kernel. Offsets in mmcv's order: ``offset[..., 2k]`` is tap k's dy,
``offset[..., 2k+1]`` its dx, taps row-major over the kernel.

``deform_conv2d`` keeps the JAX package's layouts (NHWC input, offsets
``[B, Ho, Wo, 2K]``, weight ``[K, Cin, Cout]``); ``DeformConv2dPack`` is an
NCHW module with mmcv's parameters (``weight [Cout, Cin, k, k]``,
``conv_offset``). The sample and the product are fp32 (float64 for a
float64 model) at any compute dtype, the result cast to the input's dtype:
the JAX module computes them in the input's dtype, bf16 under the bf16
policy. The gradient is autograd of the plain version (the op registers
it), as the JAX gradient is XLA's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from .. import native

__all__ = ["deform_im2col", "deform_im2col_plain", "deform_im2col_plan", "deform_conv2d",
           "DeformConv2dPack"]

DEFORM_PLAN_KEYS = ("positions", "threads", "vec", "smem_bytes")
_D1_POSITIONS = 16  # output positions of one row a block, at most
_D1_THREADS = 512  # threads a block, at most (the kernel's launch bounds)
_D1_ENTRY_BYTES = 36  # a (position, tap)'s table entry: four corner offsets, weights, the mask
_D1_MAX_SMEM = 48 * 1024
_INT32_MAX = 2 ** 31 - 1


def _out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def deform_im2col_plain(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                        kernel_size: int, stride: int, padding: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [B, H, W, C], offset [B, Ho,
    Wo, 2K], mask [B, Ho, Wo, K] or None -> col [B*Ho*Wo, K*C], col[n, k*C +
    c] tap k's bilinear sample of channel c (the JAX ``_bilinear_gather``'s
    operations in its order: the four corners' ``value * (weight * inside)``
    summed left to right, then times the mask)."""
    B, H, W, C = x.shape
    k, K = kernel_size, kernel_size * kernel_size
    Ho, Wo = _out_size(H, k, stride, padding), _out_size(W, k, stride, padding)
    dev, dt = x.device, x.dtype
    oy = torch.arange(Ho, device=dev, dtype=dt) * stride - padding
    ox = torch.arange(Wo, device=dev, dtype=dt) * stride - padding
    tap = torch.arange(K, device=dev)
    base_y = (oy[:, None, None] + (tap // k).to(dt)).expand(Ho, Wo, K)  # [Ho, Wo, K]
    base_x = (ox[None, :, None] + (tap % k).to(dt)).expand(Ho, Wo, K)
    off = offset.reshape(B, Ho, Wo, K, 2)
    py, px = base_y + off[..., 0], base_x + off[..., 1]  # [B, Ho, Wo, K]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    img = x.reshape(B, H * W, C)

    def corner(yc, xc, w):
        ok = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
        idx = (yc.clamp(0, H - 1).long() * W + xc.clamp(0, W - 1).long()).reshape(B, -1)
        g = torch.gather(img, 1, idx[..., None].expand(-1, -1, C)).view(*w.shape, C)
        return g * (w * ok)[..., None]

    col = (corner(y0, x0, (1 - wy) * (1 - wx)) + corner(y0, x0 + 1, (1 - wy) * wx)
           + corner(y0 + 1, x0, wy * (1 - wx)) + corner(y0 + 1, x0 + 1, wy * wx))
    if mask is not None:
        col = col * mask[..., None]
    return col.reshape(B * Ho * Wo, K * C)


def deform_im2col_plan(B: int, Ho: int, Wo: int, C: int, K: int, aligned: bool = True) -> dict:
    """The launch of the kernel (``csrc/deform_conv.cu``) for an output of
    B x Ho x Wo positions, C channels and K taps: ``positions`` neighbouring
    outputs of one row a block (up to 16, at most Wo, fewer where their
    table of (position, tap) entries would pass 48 KB of shared memory),
    ``threads`` a block (whole warps, up to 512, no more than the block's
    channel vectors need), ``vec`` floats a channel vector (4 where C % 4
    == 0 and x is 16-byte ``aligned``, else 1) and the shared bytes a block
    (the table). Raises ValueError on a size the kernel refuses."""
    if min(B, Ho, Wo, C, K) < 1 or max(B, Ho) > 65535 or C >= 2 ** 16:
        raise ValueError(f"deform_im2col_plan: B {B}, Ho {Ho} (1..65535), Wo {Wo}, C {C} "
                         f"(1..65535), K {K}")
    positions = min(_D1_POSITIONS, Wo, _D1_MAX_SMEM // (K * _D1_ENTRY_BYTES))
    if positions < 1:
        raise ValueError(f"deform_im2col_plan: {K} taps' table does not fit a block")
    vec = 4 if C % 4 == 0 and aligned else 1
    threads = min(_D1_THREADS, -(-positions * K * (C // vec) // 32) * 32)
    return dict(zip(DEFORM_PLAN_KEYS, (positions, threads, vec,
                                       positions * K * _D1_ENTRY_BYTES)))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = native.load_library("deform_conv").bevf_deform_im2col
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp] + [i32] * 12 + [vp]
    fn.restype = i32
    return fn


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _kernel_fn()


def _launch_im2col(x, offset, mask, kernel_size: int, stride: int, padding: int):
    """Check the operands, allocate col and launch the kernel on the current
    stream as ``deform_im2col_plan`` gives it; returns (col, whether it
    launched: nothing to sample, no launch). Sizes past int32 (x's, the
    offsets' or the column's elements) raise before anything is allocated."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"deform_im2col: want fp32 x [B, H, W, C], got {tuple(x.shape)} "
                         f"{x.dtype}")
    B, H, W, C = x.shape
    k, K = kernel_size, kernel_size * kernel_size
    Ho, Wo = _out_size(H, k, stride, padding), _out_size(W, k, stride, padding)
    if max(B * H * W * C, B * Ho * Wo * 2 * K, B * Ho * Wo * K * C) > _INT32_MAX:
        raise ValueError(f"deform_im2col: x {tuple(x.shape)} with {K} taps has more elements "
                         f"than the kernel's 32-bit indices reach")
    named = {"offset": (offset, (B, Ho, Wo, 2 * K)),
             "mask": (mask, None if mask is None else (B, Ho, Wo, K))}
    for name, (t, shape) in (("x", (x, tuple(x.shape))),) + tuple(named.items()):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"deform_im2col: {name} must be contiguous fp32 {shape} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    col = torch.empty((B * Ho * Wo, K * C), dtype=torch.float32, device=x.device)
    if col.numel() == 0:
        return col, False
    plan = deform_im2col_plan(B, Ho, Wo, C, K, aligned=x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        rc = _kernel_fn()(x.data_ptr(), offset.data_ptr(),
                          None if mask is None else mask.data_ptr(), col.data_ptr(),
                          B, H, W, C, Ho, Wo, k, stride, padding, plan["positions"],
                          plan["threads"], plan["vec"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deform_im2col: kernel launch failed with cudaError {rc}")
    return col, True


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                  kernel_size: int, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """The column buffer [B*Ho*Wo, K*C] of ``deform_im2col_plain``.

    The op ``bevfusion::deform_im2col`` (``ops/library.py``): CUDA tensors
    launch the hand-written kernel (fp32, contiguous; a block a run of one
    output row, each tap's corners once into shared memory, then the
    channels in 16-byte vectors where C % 4 == 0: ``deform_im2col_plan``)
    on the current stream; CPU tensors take the plain version; its gradient
    is autograd of the plain version. ``deform_im2col.launches`` counts
    kernel launches."""
    return torch.ops.bevfusion.deform_im2col(x, offset, mask, kernel_size, stride, padding)


deform_im2col.launches = 0


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] (NHWC); offset [B, Ho, Wo, 2K]; weight [K, Cin, Cout];
    mask [B, Ho, Wo, K] (DCNv2's modulation) or None -> [B, Ho, Wo, Cout]
    in x's dtype (computed in fp32, or float64 for float64 inputs)."""
    K, Cin, Cout = weight.shape
    k = int(round(math.sqrt(K)))
    if k * k != K:
        raise ValueError(f"deform_conv2d: {K} taps are not a square kernel")
    B, H, W, _ = x.shape
    Ho, Wo = _out_size(H, k, stride, padding), _out_size(W, k, stride, padding)
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32

    def prep(t):
        return None if t is None else t.to(dt).contiguous()

    with torch.autocast(x.device.type, enabled=False):
        col = deform_im2col(prep(x), prep(offset), prep(mask), k, stride, padding)
        out = col @ weight.to(dt).reshape(K * Cin, Cout)
    return out.view(B, Ho, Wo, Cout).to(x.dtype)


class DeformConv2dPack(nn.Module):
    """mmcv's ``DeformConv2dPack`` (DCNv1, no bias, no modulation): a
    zero-initialised ``conv_offset`` conv (k x k, padding k // 2, with bias)
    predicts every position's per-tap (dy, dx); the deformable conv (stride
    1, padding k // 2) then runs on the input. NCHW in and out; ``weight``
    ``[Cout, Cin, k, k]`` as mmcv's (the JAX package's ``[K, Cin, Cout]``,
    runtime/bridge.py converts)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        k = int(kernel_size)
        self.kernel_size = k
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.conv_offset = nn.Conv2d(in_channels, 2 * k * k, k, 1, k // 2)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        off = self.conv_offset(x)
        w = self.weight.permute(2, 3, 1, 0).reshape(k * k, self.weight.shape[1], -1)
        y = deform_conv2d(x.permute(0, 2, 3, 1), off.permute(0, 2, 3, 1), w, None, 1, k // 2)
        return y.permute(0, 3, 1, 2)
