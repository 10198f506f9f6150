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

The features run in the voxel features' dtype (the model's compute
dtype): at bf16 every sparse conv is the bf16 kernel (the fp32 weight
cast to bf16; at eval the folded BatchNorm's scale and shift fp32 into
its epilogue), the dense stage ``F.conv3d`` under autocast, and
BatchNorm takes its moments and normalises in fp32, writing bf16
(``bevfusion_tpu/models/sparse_encoder.py:57-72``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sparse_conv as sp
from ..ops.sparse_conv import _triple
from ..registry import BACKBONES
from ..utils.profiler import untimed
from .layers import at_least_fp32, batch_norm_train


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
        """x with its active entries ``m`` (0/1, broadcastable) normalised
        by their moments over ``dims``, in fp32 (or wider) and returned in
        x's dtype; inactive entries 0. Under data parallelism the moments
        are over the active sites of every rank's batch, the counts summed
        before their clamp (``parallel.masked_moments``)."""
        y = batch_norm_train(self, x, m, dims)
        return (y * m.to(y.dtype)).to(x.dtype)

    def sparse(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Training: x [N, C] site rows (the batch's samples stacked), mask [N]."""
        return self._train(x, mask[:, None], (0,))

    def dense(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """x [B, C, Z, X, Y]; active [B, 1, Z, X, Y] 0/1; inactive sites come
        out zero; the result in x's dtype."""
        if self.training:
            return self._train(x, active, (0, 2, 3, 4))
        scale, shift = self.fold()
        y = at_least_fp32(x) * scale.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1)
        return (y * active).to(x.dtype)


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
            w = w.to(xs[0].dtype)
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
    return F.max_pool3d(active, (kz, kx, ky), (sz, sx, sy), (pz, px, py)).to(active.dtype)


@BACKBONES.register
class SparseEncoder(nn.Module):
    # the strided conv between stages (its padding is per stage,
    # ``encoder_paddings``)
    DOWN_KERNEL, DOWN_STRIDE = 3, 2

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

    def sparse_sites(self, coords: torch.Tensor, mask: torch.Tensor, timed=untimed):
        """The sites of each stage that runs sparse, for one sample (coords
        [M, 3] int, x-major; mask [M]): [{"ids", "mask", "grid",
        "channels", "down"}], "channels" the stage's width and "down"
        (padding, cap_out) of the strided conv that leaves the stage
        sparse, else None. Stage 0 is always there (the input conv runs
        sparse). The caps are ``site_caps`` in order, then
        ``site_cap_multiplier`` times the last cap. ``timed(name, fn)``
        runs each downsampling."""
        grid = sp.SparseGrid(*self.sparse_shape)
        ids = sp.lin_ids(coords, grid, mask)
        cap, stages = ids.shape[0], []
        for i, layer in enumerate(self.encoder_layers.children()):
            first = layer[0]
            width = (first.conv1 if isinstance(first, SparseBasicBlock) else first[0]).weight
            stage = {"ids": ids, "mask": mask, "grid": grid, "channels": width.shape[-2],
                     "down": None}
            stages.append(stage)
            j = next((j for j, b in enumerate(layer) if not isinstance(b, SparseBasicBlock)), None)
            if j is None or 0 <= self.dense_from_stage <= i + 1:
                break
            if self.site_caps is not None and i < len(self.site_caps):
                cap = self.site_caps[i]
            else:
                cap = max(1, int(cap * self.site_cap_multiplier))
            padding = self.encoder_paddings[i][j]
            stage["down"] = (padding, cap)
            ids, mask = timed(f"s{i} meta: downsample_sites -> {cap}",
                              lambda: sp.downsample_sites(ids, grid, self.DOWN_KERNEL,
                                                          self.DOWN_STRIDE, padding, cap))
            grid = sp.conv_out_shape(grid, self.DOWN_KERNEL, self.DOWN_STRIDE, padding)
        return stages

    def forward(self, voxel_feats, coords, mask, timed=untimed):
        """voxel_feats [B, M, C]; coords [B, M, 3] int (x, y, z), sorted
        x-major per sample; mask [B, M]. Returns the BEV map
        [B, output_channels * Z_out, X_out, Y_out] (NCHW).

        The sites of every sparse stage come first (``sparse_sites``: they
        depend on the coordinates only). Then the samples go through the
        sparse stages in lockstep, layer by layer, each on its own
        rulebooks (training BN takes its moments over all of them); the
        dense stages run batched. ``timed(name, fn)`` runs each piece: the
        rulebooks, each conv, the densify (the profiling tools pass a
        timer)."""
        B = voxel_feats.shape[0]
        sites = [self.sparse_sites(coords[b], mask[b], timed) for b in range(B)]
        stage = [s[0] for s in sites]  # each sample's sites at the current sparse stage
        xs = [torch.where(mask[b][:, None], voxel_feats[b], 0.0).contiguous() for b in range(B)]
        nbrs = timed("s0 meta: build_subm_rulebook", lambda: _subm_rulebooks(stage))
        conv, bn = self.conv_input
        xs = timed(f"s0 conv_input {tuple(conv.weight.shape[-2:])}",
                   lambda: conv(xs, nbrs, bn, [s["mask"] for s in stage]))
        dense = active = None  # z-major [B, C, Z, X, Y] grid once dense

        def densify():
            d = torch.stack([sp.to_dense_zmajor(x, s["ids"], s["mask"], s["grid"])
                             .permute(3, 0, 1, 2) for x, s in zip(xs, stage)])
            occ = torch.stack([sp.occupancy_zmajor(s["ids"], s["mask"], s["grid"])
                               for s in stage])
            return d.contiguous(), occ[:, None].to(d.dtype)

        for i, layer in enumerate(self.encoder_layers.children()):
            if dense is None and self.dense_from_stage == i:
                dense, active = timed(f"s{i} densify", densify)
            for j, block in enumerate(layer):
                if isinstance(block, SparseBasicBlock):
                    C = block.conv1.weight.shape[-1]
                    if dense is None:
                        masks = [s["mask"] for s in stage]
                        ys = timed(f"s{i}.{j} subm conv1 {C}->{C}",
                                   lambda: block.conv1(xs, nbrs, block.bn1, masks))
                        xs = timed(f"s{i}.{j} subm conv2 {C}->{C} (+residual)",
                                   lambda: block.conv2(ys, nbrs, block.bn2, masks, residuals=xs))
                    else:
                        dense = timed(f"s{i}.{j} dense block {C}->{C} (2 conv3d)",
                                      lambda: _dense_block(block, dense, active))
                    continue
                conv, bn = block
                cin, cout = conv.weight.shape[-2:]
                padding = self.encoder_paddings[i][j]
                if dense is None and 0 <= self.dense_from_stage <= i + 1:
                    dense, active = timed(f"s{i} densify", densify)
                if dense is not None:
                    active = _dilate(active, self.DOWN_KERNEL, self.DOWN_STRIDE, padding)
                    dense = timed(f"s{i} strided dense conv3d {cin}->{cout}", lambda: F.relu(
                        bn.dense(conv.dense(dense, self.DOWN_STRIDE, padding), active)))
                else:
                    nxt = [s[i + 1] for s in sites]
                    cnbrs, cnbrs_t = timed(f"s{i} meta: build_conv_rulebook",
                                           lambda: _conv_rulebooks(stage, nxt, padding, xs,
                                                                   self.DOWN_KERNEL,
                                                                   self.DOWN_STRIDE))
                    xs = timed(f"s{i} strided conv {cin}->{cout}", lambda: conv(
                        xs, cnbrs, bn, [s["mask"] for s in nxt], nbrs_t=cnbrs_t))
                    stage = nxt
                    nbrs = timed(f"s{i + 1} meta: build_subm_rulebook",
                                 lambda: _subm_rulebooks(stage))

        conv, bn = self.conv_out
        k_out, s_out = (1, 1, 3), (1, 1, 2)
        name = f"conv_out {tuple(conv.weight.shape[-2:])}"
        if dense is not None:
            active = _dilate(active, k_out, s_out, 0)
            out = timed(f"{name} dense conv3d",  # [B, C, Z, X, Y]
                        lambda: F.relu(bn.dense(conv.dense(dense, s_out, 0), active)))
        else:
            out = timed(f"{name} sparse (sites, rulebooks, conv, scatter)",
                        lambda: self._sparse_conv_out(stage, xs, k_out, s_out))
        B, C, Z, X, Y = out.shape
        return out.reshape(B, C * Z, X, Y)

    def _sparse_conv_out(self, stage, xs, kernel_size, stride):
        """``conv_out`` when the last stage is sparse: each sample's output
        sites (its cap kept), the conv, the scatter to [B, C, Z, X, Y]."""
        conv, bn = self.conv_out
        grid = sp.conv_out_shape(stage[0]["grid"], kernel_size, stride, 0)
        outs = [sp.downsample_sites(s["ids"], s["grid"], kernel_size, stride, 0,
                                    s["ids"].shape[0]) for s in stage]
        dst = [{"ids": o, "mask": m, "grid": grid} for o, m in outs]
        nbrs, nbrs_t = _conv_rulebooks(stage, dst, 0, xs, kernel_size, stride)
        xs = conv(xs, nbrs, bn, [d["mask"] for d in dst], nbrs_t=nbrs_t)
        return torch.stack([sp.to_dense(x, d["ids"], d["mask"], grid).permute(3, 2, 0, 1)
                            for x, d in zip(xs, dst)])


def _subm_rulebooks(stage):
    """Each sample's submanifold gather table at its sites ``stage``."""
    return [sp.build_subm_rulebook(s["ids"], s["grid"]) for s in stage]


def _conv_rulebooks(src, dst, padding, xs, kernel_size, stride):
    """A strided conv's gather tables from each sample's sites ``src`` to
    ``dst``, and the transposed tables when the conv trains and its input
    ``xs`` needs a gradient (else None)."""
    nbrs = [sp.build_conv_rulebook(a["ids"], b["ids"], a["grid"], b["grid"], kernel_size, stride,
                                   padding) for a, b in zip(src, dst)]
    nbrs_t = None
    if torch.is_grad_enabled() and xs[0].requires_grad:
        nbrs_t = [sp.build_conv_transpose_rulebook(a["ids"], b["ids"], a["grid"], b["grid"],
                                                   kernel_size, stride, padding)
                  for a, b in zip(src, dst)]
    return nbrs, nbrs_t


def _dense_block(block: SparseBasicBlock, dense: torch.Tensor, active: torch.Tensor):
    """A residual block on the dense z-major grid."""
    y = F.relu(block.bn1.dense(block.conv1.dense(dense, 1, 1), active))
    y = block.bn2.dense(block.conv2.dense(y, 1, 1), active)
    return F.relu(y + dense) * active
