"""BEVDepth's camera-aware view transform (NCHW), eval.

Counterpart of ``SELayer``, ``ASPP``, ``DepthNet``, ``calib_mlp_input`` and
``AwareBEVDepth`` in ``bevfusion_tpu/models/bevdepth.py`` (reference
mmdet3d/models/vtransforms/aware_bevdepth.py): a 27-value calibration
vector per camera (intrinsics, image and LiDAR augmentation, camera to
ego) goes through a BatchNorm and two MLPs whose sigmoids gate the
reduced image features, one gate for the context channels and one for the
depth branch (three BasicBlocks, an atrous pyramid, a 3x3 and a 1x1 conv,
each with BN); the softmax over the D depth bins times the context is
pooled into the BEV grid as in LSS (``vtransforms._BaseLSS``).

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
a name of the port's own) before the DepthNet. The depth loss and the
refinement net are not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..registry import VTRANSFORMS
from ..utils.profiler import untimed
from .layers import BasicBlock, BatchNorm1d, BatchNorm2d, conv_bn_relu
from .vtransforms import _BaseLSS, rasterize_depth

__all__ = ["SELayer", "ASPP", "DepthNet", "calib_mlp_input", "AwareBEVDepth", "AwareDBEVDepth"]


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


@VTRANSFORMS.register
class AwareBEVDepth(_BaseLSS):
    """Camera-only BEVDepth: ``DepthNet`` on the image features and the
    calibration, then the LSS pool and the optional downsample."""

    unported_loss = "the BEVDepth depth loss (bevfusion_tpu/models/bevdepth.py:118-142)"

    def __init__(self, bevdepth_downsample: int = 8, bevdepth_refine: bool = False,
                 depth_loss_factor: float = 3.0, use_points: str = "lidar", **lss):
        """``bevdepth_downsample`` and ``depth_loss_factor`` belong to the
        depth loss; ``lss`` are ``_BaseLSS``'s arguments."""
        if bevdepth_refine:
            raise NotImplementedError("AwareBEVDepth: bevdepth_refine (DepthRefinement) is not "
                                      "ported; no config sets it")
        super().__init__(**lss)
        self.use_points = use_points

    def build_nets(self, in_channels: int) -> None:
        self.depthnet = DepthNet(in_channels, in_channels, self.C, self.D)

    def add_depth(self, x: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                  mats: Dict[str, torch.Tensor], timed=untimed) -> torch.Tensor:
        """The DepthNet's input from the image features [B*N, Cin, fH, fW]:
        they alone here (the points are not used)."""
        return x

    def forward(self, img_feats: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                mats: Dict[str, torch.Tensor], timed=untimed) -> torch.Tensor:
        """img_feats [B, N, Cin, fH, fW] -> BEV [B, C, X', Y'].
        ``timed(name, fn)`` runs each piece."""
        B, N, Cin, fH, fW = img_feats.shape
        mlp_in = calib_mlp_input(mats["camera_intrinsics"][..., :3, :3].float(),
                                 mats["img_aug_matrix"].float(), mats["lidar_aug_matrix"].float(),
                                 mats["camera2ego"].float())
        x = self.add_depth(img_feats.reshape(B * N, Cin, fH, fW), points, points_mask, mats, timed)
        x = timed("depthnet", lambda: self.depthnet(x, mlp_in))
        return self.to_bev(x, B, mats, timed)


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
