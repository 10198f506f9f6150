"""SparseEncoder (VoxelNet middle encoder) on the Hopper sparse-conv kernel.

Counterpart of ``bevfusion_tpu/models/sparse_encoder.py`` with the stage
structure of its windowed engine (reference
mmdet3d/models/backbones/sparse_encoder.py:11-218, basicblock variant):
a submanifold input conv, stages of two residual submanifold blocks with
a stride-2 sparse conv between stages, and a (1, 1, 3)/(1, 1, 2)
``conv_out``, reshaped to a BEV map whose channel ``c*Z + z`` matches
the reference's permute+view.

Stages before ``dense_from_stage`` are sparse: at eval every conv is one
launch of the gather-GEMM kernel per sample over a rulebook shared by
the stage, with the eval BatchNorm folded into its epilogue (scale,
shift, then the residual, then ReLU). In training every conv is a
``SparseConvFunction`` (the same kernel forward and for backward-data,
the weight-gradient kernel for the weight), and BatchNorm takes its
moments over the active sites of the whole batch (the JAX package's
``engine="gather"`` path and ``MaskedBatchNorm``). The strided conv into
stage ``dense_from_stage`` and everything after it run as dense masked
3D convs (``F.conv3d``) on a z-major ``[B, C, Z, X, Y]`` grid, which is
exact:

    subm     = conv3d(x) * active
    strided  = conv3d(x, stride 2) * maxpool(active)

Module and parameter names follow the reference checkpoint
(``conv_input``, ``encoder_layers.encoder_layerN.M.conv1`` ...; spconv
weights ``[kx, ky, kz, Cin, Cout]``), so a released state dict loads
as is.
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
    """BatchNorm over active sites (``bevfusion_tpu`` MaskedBatchNorm). At
    eval its running statistics fold into a per-channel affine. In training
    the moments are taken over the active sites of the whole batch (biased
    variance, two passes), the running statistics move by ``momentum``
    (torch convention) towards them, and inactive sites come out zero."""

    def fold(self):
        """(scale, shift) with ``bn(x) == x * scale + shift``."""
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale

    def _train(self, x: torch.Tensor, m: torch.Tensor, dims) -> torch.Tensor:
        """x with its active entries ``m`` (float 0/1, broadcastable)
        normalised by their moments over ``dims``; inactive entries 0."""
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dims, keepdim=True) / cnt
        var = ((x - mean) ** 2 * m).sum(dims, keepdim=True) / cnt
        with torch.no_grad():
            self.running_mean.lerp_(mean.flatten(), self.momentum)
            self.running_var.lerp_(var.flatten(), self.momentum)
            self.num_batches_tracked += 1
        shape = mean.shape
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight.view(shape) \
            + self.bias.view(shape)
        return y * m

    def sparse(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Training: x [N, C] site rows (the batch's samples stacked), mask [N]."""
        return self._train(x, mask[:, None].to(x.dtype), (0,))

    def dense(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """x [B, C, Z, X, Y]; active [B, 1, Z, X, Y] float 0/1; inactive
        sites come out zero."""
        if self.training:
            return self._train(x, active, (0, 2, 3, 4))
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

    def forward(self, xs, nbrs, bn: MaskedBatchNorm, masks, residuals=None, nbrs_t=None):
        """Sparse conv + BN (+ residual) + ReLU over the batch's samples
        (lists of site rows ``xs``, tables ``nbrs``, output ``masks``,
        ``residuals``). Eval: one kernel launch per sample with BN folded
        into its epilogue. Training: one ``SparseConvFunction`` per sample
        (``nbrs_t``: the transposed tables of a strided conv), BN moments
        over the active sites of the whole batch, then residual and ReLU."""
        w = self.weight.reshape(-1, *self.weight.shape[-2:])
        residuals = residuals or [None] * len(xs)
        if not self.training:
            scale, shift = bn.fold()
            return [sp.sparse_conv(x, nbr, w, scale, shift, r, relu=True)
                    for x, nbr, r in zip(xs, nbrs, residuals)]
        nbrs_t = nbrs_t or [None] * len(xs)
        ys = [sp.SparseConvFunction.apply(x, w, nbr, nt) for x, nbr, nt in zip(xs, nbrs, nbrs_t)]
        y = bn.sparse(torch.cat(ys), torch.cat(masks))
        if residuals[0] is not None:
            y = y + torch.cat(residuals)
        return list(torch.relu(y).split([t.shape[0] for t in ys]))

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
        [B, output_channels * Z_out, X_out, Y_out] (NCHW).

        The samples go through the sparse stages in lockstep, layer by
        layer, each on its own rulebooks (training BN takes its moments
        over all of them); the dense stages run batched."""
        grid = sp.SparseGrid(*self.sparse_shape)
        B = voxel_feats.shape[0]
        ids = [sp.lin_ids(coords[b], grid, mask[b]) for b in range(B)]
        masks = list(mask)
        xs = [torch.where(mask[b][:, None], voxel_feats[b], 0.0).contiguous() for b in range(B)]
        nbrs = [sp.build_subm_rulebook(i, grid) for i in ids]
        xs = self.conv_input[0](xs, nbrs, self.conv_input[1], masks)
        cap = xs[0].shape[0]
        n_down = 0
        dense = active = None  # z-major [B, C, Z, X, Y] grid once dense

        def densify():
            d = torch.stack([sp.to_dense_zmajor(x, i, m, grid).permute(3, 0, 1, 2)
                             for x, i, m in zip(xs, ids, masks)])
            occ = torch.stack([sp.occupancy_zmajor(i, m, grid) for i, m in zip(ids, masks)])
            return d.contiguous(), occ[:, None].float()

        for i, layer in enumerate(self.encoder_layers.children()):
            if dense is None and self.dense_from_stage == i:
                dense, active = densify()
            for j, block in enumerate(layer):
                if isinstance(block, SparseBasicBlock):
                    if dense is None:
                        ys = block.conv1(xs, nbrs, block.bn1, masks)
                        xs = block.conv2(ys, nbrs, block.bn2, masks, residuals=xs)
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
                    ids, masks, grid, nbrs, nbrs_t = self._downsample(ids, grid, padding,
                                                                      cap_out, xs)
                    xs = conv(xs, nbrs, bn, masks, nbrs_t=nbrs_t)
                    cap = cap_out
                    nbrs = [sp.build_subm_rulebook(i, grid) for i in ids]
                n_down += 1

        conv, bn = self.conv_out
        k_out, s_out = (1, 1, 3), (1, 1, 2)
        if dense is not None:
            active = _dilate(active, k_out, s_out, 0)
            out = F.relu(bn.dense(conv.dense(dense, s_out, 0), active))  # [B, C, Z, X, Y]
        else:
            ids, masks, grid, nbrs, nbrs_t = self._downsample(ids, grid, 0, cap, xs,
                                                              k_out, s_out)
            xs = conv(xs, nbrs, bn, masks, nbrs_t=nbrs_t)
            out = torch.stack([sp.to_dense(x, i, m, grid).permute(3, 2, 0, 1)
                               for x, i, m in zip(xs, ids, masks)])
        B, C, Z, X, Y = out.shape
        return out.reshape(B, C * Z, X, Y)

    def _downsample(self, ids, grid, padding, cap_out, xs, kernel_size=3, stride=2):
        """Output sites of a strided conv per sample: (ids, masks, grid,
        gather tables, transposed tables when the conv trains and its input
        needs a gradient, else None)."""
        out_grid = sp.conv_out_shape(grid, kernel_size, stride, padding)
        outs = [sp.downsample_sites(i, grid, kernel_size, stride, padding, cap_out) for i in ids]
        out_ids = [o for o, _ in outs]
        nbrs = [sp.build_conv_rulebook(i, o, grid, out_grid, kernel_size, stride, padding)
                for i, o in zip(ids, out_ids)]
        nbrs_t = None
        if torch.is_grad_enabled() and xs[0].requires_grad:
            nbrs_t = [sp.build_conv_transpose_rulebook(i, o, grid, out_grid, kernel_size, stride,
                                                       padding) for i, o in zip(ids, out_ids)]
        return out_ids, [m for _, m in outs], out_grid, nbrs, nbrs_t
