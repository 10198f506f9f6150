"""SparseEncoder (VoxelNet middle encoder) on the Hopper sparse-conv kernel.

Counterpart of ``bevfusion_tpu/models/sparse_encoder.py`` with the stage
structure of its windowed engine (reference
mmdet3d/models/backbones/sparse_encoder.py:11-218, basicblock variant):
a submanifold input conv, stages of two residual submanifold blocks with
a stride-2 sparse conv between stages, and a (1, 1, 3)/(1, 1, 2)
``conv_out``, reshaped to a BEV map whose channel ``c*Z + z`` matches
the reference's permute+view.

Stages before ``dense_from_stage`` are sparse: every conv is one launch
of the gather-GEMM kernel over a rulebook shared by the stage, with the
eval BatchNorm folded into its epilogue (scale, shift, then the
residual, then ReLU). The strided conv into stage ``dense_from_stage``
and everything after it run as dense masked 3D convs (``F.conv3d``) on
a z-major ``[B, C, Z, X, Y]`` grid, which is exact:

    subm     = conv3d(x) * active
    strided  = conv3d(x, stride 2) * maxpool(active)

Module and parameter names follow the reference checkpoint
(``conv_input``, ``encoder_layers.encoder_layerN.M.conv1`` ...; spconv
weights ``[kx, ky, kz, Cin, Cout]``), so a released state dict loads
as is. Eval only: training comes with the kernel's backward.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sparse_conv as sp
from ..ops.sparse_conv import _triple
from ..registry import BACKBONES


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over active sites (``bevfusion_tpu`` MaskedBatchNorm) at
    eval: its running statistics fold into a per-channel affine."""

    def fold(self):
        """(scale, shift) with ``bn(x) == x * scale + shift``."""
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale

    def dense(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """x [B, C, Z, X, Y]; active [B, 1, Z, X, Y] float 0/1; inactive
        sites come out zero."""
        scale, shift = self.fold()
        return (x * scale.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1)) * active


class SparseConv3d(nn.Module):
    """One sparse conv's weight, ``[kx, ky, kz, Cin, Cout]`` like spconv;
    the kernel reads it as ``[K, Cin, Cout]`` (x-major, z-minor)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        fan_in = in_channels * self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        self.weight = nn.Parameter(
            torch.randn(*self.kernel_size, in_channels, out_channels) * fan_in ** -0.5)

    def forward(self, feats, nbr, bn: MaskedBatchNorm, residual=None):
        """Sparse conv + folded BN (+ residual) + ReLU: one kernel launch."""
        scale, shift = bn.fold()
        w = self.weight.reshape(-1, *self.weight.shape[-2:])
        return sp.sparse_conv(feats, nbr, w, scale, shift, residual, relu=True)

    def dense(self, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
        """The same conv on a dense z-major grid x [B, Cin, Z, X, Y]."""
        (sx, sy, sz), (px, py, pz) = _triple(stride), _triple(padding)
        w = self.weight.permute(4, 3, 2, 0, 1)  # [Cout, Cin, kz, kx, ky]
        return F.conv3d(x, w, stride=(sz, sx, sy), padding=(pz, px, py))


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with BN and a residual (reference
    ops/sparse_block.py:42-47 naming)."""

    def __init__(self, channels: int, eps: float, momentum: float):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels, 3)
        self.bn1 = MaskedBatchNorm(channels, eps, momentum)
        self.conv2 = SparseConv3d(channels, channels, 3)
        self.bn2 = MaskedBatchNorm(channels, eps, momentum)


def _conv_bn(cin: int, cout: int, kernel_size, eps: float, momentum: float):
    """(conv, bn) pair keyed ``0``/``1`` like the reference's
    SparseSequential(conv, bn, relu); the ReLU lives in the kernel."""
    return nn.Sequential(SparseConv3d(cin, cout, kernel_size),
                         MaskedBatchNorm(cout, eps, momentum))


def _dilate(active: torch.Tensor, kernel_size, stride, padding) -> torch.Tensor:
    """Active output sites of a strided conv on the z-major grid."""
    (kx, ky, kz), (sx, sy, sz), (px, py, pz) = (
        _triple(kernel_size), _triple(stride), _triple(padding))
    return F.max_pool3d(active, (kz, kx, ky), (sz, sx, sy), (pz, px, py))


@BACKBONES.register
class SparseEncoder(nn.Module):
    def __init__(self, in_channels: int, sparse_shape: Sequence[int],
                 order: Sequence[str] = ("conv", "norm", "act"),
                 norm_cfg: Optional[dict] = None, base_channels: int = 16,
                 output_channels: int = 128,
                 encoder_channels=((16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
                 encoder_paddings=((1,), (1, 1, 1), (1, 1, 1), ((0, 1, 1), 1, 1)),
                 block_type: str = "conv_module", site_cap_multiplier: float = 1.0,
                 site_caps: Optional[Sequence[int]] = None, dense_from_stage: int = 3):
        super().__init__()
        if block_type != "basicblock" or tuple(order) != ("conv", "norm", "act"):
            raise NotImplementedError(
                "the port runs block_type='basicblock' with order conv/norm/act "
                "(ROADMAP: remaining SparseEncoder variants)")
        cfg = norm_cfg or {"type": "BN1d", "eps": 1e-3, "momentum": 0.01}
        eps, momentum = cfg.get("eps", 1e-3), cfg.get("momentum", 0.01)
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        self.encoder_paddings = [list(p) for p in encoder_paddings]
        self.site_cap_multiplier = site_cap_multiplier
        self.site_caps = None if site_caps is None else [int(c) for c in site_caps]
        self.dense_from_stage = dense_from_stage

        self.conv_input = _conv_bn(in_channels, base_channels, 3, eps, momentum)
        self.encoder_layers = nn.Module()
        cin = base_channels
        n = len(encoder_channels)
        for i, blocks in enumerate(encoder_channels):
            layer = nn.Sequential()
            for j, cout in enumerate(blocks):
                if j == len(blocks) - 1 and i != n - 1:  # stride-2 transition
                    layer.add_module(str(j), _conv_bn(cin, cout, 3, eps, momentum))
                else:
                    if cout != cin:
                        raise ValueError(f"basic block {i}.{j}: {cin} -> {cout} channels")
                    layer.add_module(str(j), SparseBasicBlock(cout, eps, momentum))
                cin = cout
            self.encoder_layers.add_module(f"encoder_layer{i + 1}", layer)
        self.conv_out = _conv_bn(cin, output_channels, (1, 1, 3), eps, momentum)

    def forward(self, voxel_feats, coords, mask):
        """voxel_feats [B, M, C]; coords [B, M, 3] int (x, y, z), sorted
        x-major per sample; mask [B, M]. Returns the BEV map
        [B, output_channels * Z_out, X_out, Y_out] (NCHW)."""
        if self.training:
            raise NotImplementedError("SparseEncoder runs eval only (ROADMAP: training)")
        return torch.cat([self._forward_one(f, c, m)
                          for f, c, m in zip(voxel_feats, coords, mask)])

    def _forward_one(self, feats, coords, mask):
        grid = sp.SparseGrid(*self.sparse_shape)
        ids = sp.lin_ids(coords, grid, mask)
        x = torch.where(mask[:, None], feats, 0.0).contiguous()
        nbr = sp.build_subm_rulebook(ids, grid)
        x = self.conv_input[0](x, nbr, self.conv_input[1])
        cap = x.shape[0]
        n_down = 0
        dense = active = None  # z-major [1, C, Z, X, Y] grid once dense

        def densify():
            d = sp.to_dense_zmajor(x, ids, mask, grid).permute(3, 0, 1, 2)[None]
            return d.contiguous(), sp.occupancy_zmajor(ids, mask, grid)[None, None].float()

        for i, layer in enumerate(self.encoder_layers.children()):
            if dense is None and self.dense_from_stage == i:
                dense, active = densify()
            for j, block in enumerate(layer):
                if isinstance(block, SparseBasicBlock):
                    if dense is None:
                        y = block.conv1(x, nbr, block.bn1)
                        x = block.conv2(y, nbr, block.bn2, residual=x)
                    else:
                        y = F.relu(block.bn1.dense(block.conv1.dense(dense, 1, 1), active))
                        y = block.bn2.dense(block.conv2.dense(y, 1, 1), active)
                        dense = F.relu(y + dense) * active
                    continue
                conv, bn = block
                padding = self.encoder_paddings[i][j]
                if dense is None and 0 <= self.dense_from_stage <= i + 1:
                    dense, active = densify()
                if dense is not None:
                    active = _dilate(active, 3, 2, padding)
                    dense = F.relu(bn.dense(conv.dense(dense, 2, padding), active))
                    grid = sp.conv_out_shape(grid, 3, 2, padding)
                else:
                    if self.site_caps is not None and n_down < len(self.site_caps):
                        cap_out = self.site_caps[n_down]
                    else:
                        cap_out = max(1, int(cap * self.site_cap_multiplier))
                    out_grid = sp.conv_out_shape(grid, 3, 2, padding)
                    out_ids, out_mask = sp.downsample_sites(ids, grid, 3, 2, padding, cap_out)
                    cnbr = sp.build_conv_rulebook(ids, out_ids, grid, out_grid, 3, 2, padding)
                    x = conv(x, cnbr, bn)
                    ids, mask, grid, cap = out_ids, out_mask, out_grid, cap_out
                    nbr = sp.build_subm_rulebook(ids, grid)
                n_down += 1

        conv, bn = self.conv_out
        k_out, s_out = (1, 1, 3), (1, 1, 2)
        if dense is not None:
            active = _dilate(active, k_out, s_out, 0)
            out = F.relu(bn.dense(conv.dense(dense, s_out, 0), active))  # [1, C, Z, X, Y]
        else:
            out_grid = sp.conv_out_shape(grid, k_out, s_out, 0)
            out_ids, out_mask = sp.downsample_sites(ids, grid, k_out, s_out, 0, cap)
            cnbr = sp.build_conv_rulebook(ids, out_ids, grid, out_grid, k_out, s_out, 0)
            x = conv(x, cnbr, bn)
            out = sp.to_dense(x, out_ids, out_mask, out_grid).permute(3, 2, 0, 1)[None]
        _, C, Z, X, Y = out.shape
        return out.reshape(1, C * Z, X, Y)
