"""BEVDepth's camera-aware view transform (NCHW) and its depth loss.

Counterpart of ``SELayer``, ``ASPP``, ``DepthNet``, ``calib_mlp_input``,
``downsampled_gt_depth``, ``bce_depth_loss`` and ``AwareBEVDepth`` in
``bevfusion_tpu/models/bevdepth.py`` (reference
mmdet3d/models/vtransforms/aware_bevdepth.py): a 27-value calibration
vector per camera (intrinsics, image and LiDAR augmentation, camera to
ego) goes through a BatchNorm and two MLPs whose sigmoids gate the
reduced image features, one gate for the context channels and one for the
depth branch (three BasicBlocks, an atrous pyramid, a 3x3 and a 1x1 conv,
each with BN); the softmax over the D depth bins times the context is
pooled into the BEV grid as in LSS (``vtransforms._BaseLSS``). Given the
LiDAR depth images (``data/transforms.py:GTDepth``) in training, the
forward also returns the depth loss: the binary cross-entropy of the depth
softmax against the one-hot bin of each ``bevdepth_downsample`` block's
nearest return, on the blocks that hold one.

The gate is the JAX package's: ``x * sigmoid(mlp(calib))``, with no
parameters of its own (the reference's SELayer adds ``conv_reduce`` and
``conv_expand``; ROADMAP Queue 3, inherited divergences). Module names
follow BEVDepth's DepthNet (``reduce_conv``, ``bn``, ``{depth,context}_mlp.
{fc1,fc2}``, ``context_conv``, ``depth_conv.{0..7}`` with the pyramid at
``depth_conv.3``: ``aspp{1..4}.{atrous_conv,bn}``, ``global_avg_pool.{1,2}``,
``conv1``, ``bn1``); ``runtime/bridge.py`` maps the JAX names onto them.
``AwareDBEVDepth`` adds the sparse depth of the points its ``use_points``
names (LiDAR or radar): rasterized per camera, encoded by three strided
conv-BN-ReLUs (``dtransform.{0..8}``, DepthLSS's, to 1/8 of the image),
concatenated with the image features and brought back to their width by a
3x3 conv-BN-ReLU (``fuse_depth.{0,1}``, the JAX package's ``fuse_depth``:
a name of the port's own) before the DepthNet. The refinement net is not
ported (``bevdepth_refine``: the JAX package never reads it; every config
sets it false).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from ..registry import VTRANSFORMS
from ..utils.profiler import untimed
from .layers import BasicBlock, BatchNorm1d, BatchNorm2d, at_least_fp32, conv_bn_relu
from .vtransforms import _BaseLSS, rasterize_depth

__all__ = ["SELayer", "ASPP", "DepthNet", "calib_mlp_input", "downsampled_gt_depth",
           "bce_depth_loss", "AwareBEVDepth", "AwareDBEVDepth"]


class SELayer(nn.Module):
    """``x [B, C, H, W] * sigmoid(gate [B, C])``."""

    def forward(self, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        return x * gate.sigmoid()[:, :, None, None].to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out_features)

    def forward(self, x):
        return self.fc2(self.fc1(x).relu())


class _ASPPModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int):
        super().__init__()
        pad = 0 if kernel_size == 1 else dilation
        self.atrous_conv = nn.Conv2d(in_channels, out_channels, kernel_size, 1, pad, dilation,
                                     bias=False)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x):
        return self.bn(self.atrous_conv(x)).relu()


class ASPP(nn.Module):
    """Atrous pyramid: dilations 1, 6, 12, 18 and a global-average branch,
    concatenated, then a 1x1 conv-BN-ReLU."""

    def __init__(self, in_channels: int, mid_channels: int = 256):
        super().__init__()
        for i, (k, d) in enumerate(((1, 1), (3, 6), (3, 12), (3, 18))):
            self.add_module(f"aspp{i + 1}", _ASPPModule(in_channels, mid_channels, k, d))
        self.global_avg_pool = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                             *conv_bn_relu(in_channels, mid_channels, 1))
        self.conv1 = nn.Conv2d(5 * mid_channels, mid_channels, 1, bias=False)
        self.bn1 = BatchNorm2d(mid_channels)

    def forward(self, x):
        outs = [getattr(self, f"aspp{i}")(x) for i in range(1, 5)]
        outs.append(self.global_avg_pool(x).expand_as(outs[0]))
        return self.bn1(self.conv1(torch.cat(outs, 1))).relu()


class DepthNet(nn.Module):
    """Image features [BN, Cin, fH, fW] and the calibration vectors [BN, 27]
    -> D depth logits then C context channels per pixel."""

    def __init__(self, in_channels: int, mid_channels: int, context_channels: int,
                 depth_channels: int):
        super().__init__()
        mid = mid_channels
        self.reduce_conv = nn.Sequential(*conv_bn_relu(in_channels, mid, 3, 1, 1, bias=True))
        self.bn = BatchNorm1d(27)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer()
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer()
        self.context_conv = nn.Conv2d(mid, context_channels, 1)
        self.depth_conv = nn.Sequential(
            BasicBlock(mid, mid), BasicBlock(mid, mid), BasicBlock(mid, mid), ASPP(mid, mid),
            nn.Conv2d(mid, mid, 3, 1, 1), BatchNorm2d(mid),
            nn.Conv2d(mid, depth_channels, 1), BatchNorm2d(depth_channels))

    def forward(self, x: torch.Tensor, mlp_input: torch.Tensor) -> torch.Tensor:
        x = self.reduce_conv(x)
        mi = self.bn(mlp_input)
        ctx = self.context_conv(self.context_se(x, self.context_mlp(mi)))
        depth = self.depth_conv(self.depth_se(x, self.depth_mlp(mi)))
        return torch.cat([depth, ctx], 1)


def calib_mlp_input(intrins: torch.Tensor, img_aug: torch.Tensor, lidar_aug: torch.Tensor,
                    camera2ego: torch.Tensor) -> torch.Tensor:
    """The 27-value calibration vector per camera (aware_bevdepth.py:285-312):
    intrins [B, N, 3, 3], img_aug and camera2ego [B, N, 4, 4], lidar_aug
    [B, 4, 4] -> [B*N, 27]."""
    B, N = intrins.shape[:2]
    bda = lidar_aug[:, None].expand(B, N, 4, 4)
    feats = torch.stack([
        intrins[..., 0, 0], intrins[..., 1, 1], intrins[..., 0, 2], intrins[..., 1, 2],
        img_aug[..., 0, 0], img_aug[..., 0, 1], img_aug[..., 0, 3],
        img_aug[..., 1, 0], img_aug[..., 1, 1], img_aug[..., 1, 3],
        bda[..., 0, 0], bda[..., 0, 1], bda[..., 1, 0], bda[..., 1, 1], bda[..., 2, 2]], -1)
    return torch.cat([feats, camera2ego[..., :3, :4].reshape(B, N, 12)], -1).reshape(B * N, 27)


def downsampled_gt_depth(gt_depths: torch.Tensor, factor: int, dbound: Sequence[float],
                         D: int) -> torch.Tensor:
    """Depth images [B, N, H, W] (0 where no point) -> one-hot depth bins
    [B*N*(H/factor)*(W/factor), D], blocks in (camera, row, column) order
    (aware_bevdepth.py:442-478): each factor x factor block's nearest depth
    (0 counts as 1e5), binned by ``dbound`` (start, stop, step) over D + 1
    bins with bin 0 and anything out of range as background, bin 0 dropped;
    a background block is a row of zeros."""
    B, N, H, W = gt_depths.shape
    g = gt_depths.reshape(B * N, H // factor, factor, W // factor, factor)
    g = g.permute(0, 1, 3, 2, 4).reshape(-1, factor * factor)
    g = torch.where(g == 0.0, torch.full_like(g, 1e5), g).amin(-1)
    g = (g - (dbound[0] - dbound[2])) / dbound[2]
    g = torch.where((g < D + 1) & (g >= 0.0), g, torch.zeros_like(g))
    return F.one_hot(g.long(), D + 1)[:, 1:].to(gt_depths.dtype)


def bce_depth_loss(depth: torch.Tensor, gt_depths: torch.Tensor, factor: int,
                   dbound: Sequence[float], D: int, loss_factor: float = 3.0) -> torch.Tensor:
    """The depth loss: ``depth`` [B, N, D, fH, fW] softmax probabilities,
    ``gt_depths`` [B, N, H, W]; the binary cross-entropy against
    ``downsampled_gt_depth`` (probabilities clipped to [1e-6, 1 - 1e-6]),
    summed over the blocks that hold a return and their D bins, over the
    number of those blocks (at least 1), times ``loss_factor``."""
    preds = at_least_fp32(depth).permute(0, 1, 3, 4, 2).reshape(-1, D)
    labels = downsampled_gt_depth(gt_depths, factor, dbound, D).to(preds.dtype)
    fg = labels.amax(1) > 0.0
    p = preds.clamp(1e-6, 1 - 1e-6)
    bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    bce = torch.where(fg[:, None], bce, torch.zeros_like(bce))
    # the blocks of every rank's batch under data parallelism
    return loss_factor * bce.sum() / torch.clamp(parallel.count_sum(fg.sum().to(bce.dtype)),
                                                 min=1.0)


@VTRANSFORMS.register
class AwareBEVDepth(_BaseLSS):
    """Camera-only BEVDepth: ``DepthNet`` on the image features and the
    calibration, then the LSS pool and the optional downsample; the depth
    loss (``bce_depth_loss``) where the caller passes depth images."""

    def __init__(self, bevdepth_downsample: int = 8, bevdepth_refine: bool = False,
                 depth_loss_factor: float = 3.0, use_points: str = "lidar", **lss):
        """``bevdepth_downsample`` and ``depth_loss_factor`` belong to the
        depth loss; ``lss`` are ``_BaseLSS``'s arguments."""
        if bevdepth_refine:
            raise NotImplementedError("AwareBEVDepth: bevdepth_refine (DepthRefinement) is not "
                                      "ported; no config sets it")
        super().__init__(**lss)
        self.use_points = use_points
        self.bevdepth_downsample = bevdepth_downsample
        self.depth_loss_factor = depth_loss_factor

    def build_nets(self, in_channels: int) -> None:
        self.depthnet = DepthNet(in_channels, in_channels, self.C, self.D)

    def add_depth(self, x: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                  mats: Dict[str, torch.Tensor], timed=untimed) -> torch.Tensor:
        """The DepthNet's input from the image features [B*N, Cin, fH, fW]:
        they alone here (the points are not used)."""
        return x

    def forward(self, img_feats: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                mats: Dict[str, torch.Tensor], timed=untimed,
                gt_depths: Optional[torch.Tensor] = None):
        """img_feats [B, N, Cin, fH, fW] -> BEV [B, C, X', Y']; with
        ``gt_depths`` [B, N, iH, iW], (BEV, depth loss). ``timed(name, fn)``
        runs each piece."""
        B, N, Cin, fH, fW = img_feats.shape
        mlp_in = calib_mlp_input(*(at_least_fp32(m) for m in (
            mats["camera_intrinsics"][..., :3, :3], mats["img_aug_matrix"],
            mats["lidar_aug_matrix"], mats["camera2ego"])))
        x = self.add_depth(img_feats.reshape(B * N, Cin, fH, fW), points, points_mask, mats, timed)
        x = timed("depthnet", lambda: self.depthnet(x, mlp_in))
        if gt_depths is None:
            return self.to_bev(x, B, mats, timed)
        bev, depth = self.to_bev(x, B, mats, timed, return_depth=True)
        return bev, timed("depth_loss", lambda: bce_depth_loss(
            depth, gt_depths, self.bevdepth_downsample, self.dbound, self.D,
            self.depth_loss_factor))


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


@VTRANSFORMS.register
class AwareDBEVDepth(AwareBEVDepth):
    """BEVDepth with the sparse depth of ``use_points`` (aware_bevdepth.py:
    503-697, as the JAX package has it): the depth image's features at 1/8
    of the image are concatenated with the image features before the
    DepthNet, so the features must be at stride 8. Elsewhere (a stride-16
    neck, as camera+radar/resnet50/dlss.yaml has) the two maps differ in
    size and the build raises; the JAX package fails there too, at the
    concatenation (ROADMAP Queue 3)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        iH, iW = self.image_size
        depth = tuple(_conv_out(_conv_out(s, 5, 4, 2), 5, 2, 2) for s in (iH, iW))
        feats = tuple(self.frustum.shape[1:3])
        if depth != feats:
            raise ValueError(
                f"AwareDBEVDepth: the depth branch gives {depth[0]} x {depth[1]} (image "
                f"{iH} x {iW} at stride 8) but the image features are {feats[0]} x {feats[1]}: "
                "the two are concatenated, so the features must be at stride 8. The JAX "
                "package fails at the same concatenation (bevfusion_tpu/models/bevdepth.py:208)")

    def build_nets(self, in_channels: int) -> None:
        self.dtransform = nn.Sequential(*conv_bn_relu(1, 8, 1, bias=True),
                                        *conv_bn_relu(8, 32, 5, 4, 2, bias=True),
                                        *conv_bn_relu(32, 64, 5, 2, 2, bias=True))
        self.fuse_depth = nn.Sequential(*conv_bn_relu(in_channels + 64, in_channels, 3, 1, 1,
                                                      bias=True))
        super().build_nets(in_channels)

    def add_depth(self, x: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                  mats: Dict[str, torch.Tensor], timed=untimed) -> torch.Tensor:
        """[the encoded depth image, the image features] -> ``fuse_depth``."""
        d = timed("rasterize_depth", lambda: rasterize_depth(
            points, points_mask, mats["lidar2image"], mats["img_aug_matrix"],
            mats["lidar_aug_matrix"], self.image_size))
        d = timed("dtransform", lambda: self.dtransform(d.view(x.shape[0], 1, *self.image_size)))
        return timed("fuse_depth", lambda: self.fuse_depth(torch.cat([d, x], 1)))
