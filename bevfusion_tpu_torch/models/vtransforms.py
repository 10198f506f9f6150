"""LSS view transform of the camera branch: image features -> BEV (NCHW).

Counterpart of ``bevfusion_tpu/models/vtransforms.py``: ``get_geometry``,
``rasterize_depth``, and the two LSS transforms on one base (the JAX
``_BaseLSS``): ``LSSTransform`` (reference mmdet3d/models/vtransforms/
lss.py:14-78: a 1x1 depthnet on the image features alone) and
``DepthLSSTransform`` (depth_lss.py:15-101, with the JAX package's
1-channel sparse depth). Module names follow the reference checkpoint:
``dtransform.{0..8}``, ``depthnet`` (LSS: one conv; DepthLSS:
``depthnet.{0..6}``), ``downsample.{0..8}``.

Geometry is true fp32 on every device: the 3x3 transforms are broadcast
multiply-adds (no matmul, so no TF32 setting reaches them; on the TPU a
bf16 contraction moved points by up to 0.2 m), and the 3x3 inverses are
taken in float64 like the JAX package's host LUT. ``build_pool_lut``
makes the pool's intervals from the calibration; the same function serves
the host LUT of a deployed rig and the in-graph route. The BEVDepth family
(``AwareBEVDepth``, ``AwareDBEVDepth``) lives in ``models/bevdepth.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.bev_pool import BEVPoolFunction, PoolIntervals, build_intervals, cell_ids_from_geometry
from ..ops.grid import create_frustum, gen_dx_bx
from ..registry import VTRANSFORMS
from ..runtime.precision import fp32_region
from ..utils.profiler import untimed
from .layers import at_least_fp32, conv_bn_relu

__all__ = ["get_geometry", "rasterize_depth", "lss_constants", "build_pool_lut",
           "LSSTransform", "DepthLSSTransform"]


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m [..., 3, 3] @ v [..., 3]`` (broadcasting) as fp32 multiply-adds."""
    return m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2] + m[..., 2] * v[..., 2:3]


def _inv3(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(m.double()).float()


def get_geometry(frustum, camera2lidar, intrins, img_aug, lidar_aug):
    """Frustum (u, v, d) points [D, fH, fW, 3] -> lidar-frame xyz
    [B, N, D, fH, fW, 3]: undo the image augmentation, unproject, camera ->
    lidar, lidar augmentation. Matrices [B, N, 4, 4], intrins [B, N, 3, 3],
    lidar_aug [B, 4, 4]."""
    def per_cam(t):  # [B, N, ...] -> [B, N, 1, 1, 1, ...] against [B, N, D, fH, fW, 3]
        return t.float()[:, :, None, None, None]

    pts = frustum.float()[None, None] - per_cam(img_aug[..., :3, 3])
    pts = _matvec(per_cam(_inv3(img_aug[..., :3, :3])), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    combine = (camera2lidar[..., :3, :3].double() @ torch.linalg.inv(intrins.double())).float()
    pts = _matvec(per_cam(combine), pts) + per_cam(camera2lidar[..., :3, 3])
    lidar_aug = lidar_aug.float()[:, None, None, None, None]
    return _matvec(lidar_aug[..., :3, :3], pts) + lidar_aug[..., :3, 3]


def rasterize_depth(points, points_mask, lidar2image, img_aug, lidar_aug, image_size):
    """LiDAR points [B, P, >=3] (mask [B, P]) projected into per-camera
    sparse depth images [B, N, iH, iW]: where several points land on one
    pixel the minimum distance is kept (the JAX package's choice; the
    reference keeps the last writer). Rows and columns truncate toward
    zero; only points in front of the camera, on the image and unmasked
    count; pixels without a point are 0."""
    iH, iW = image_size
    B, P = points.shape[:2]
    N = lidar2image.shape[1]
    xyz = points[..., :3].float() - lidar_aug[:, None, :3, 3].float()
    xyz = _matvec(_inv3(lidar_aug[:, :3, :3])[:, None], xyz)  # undo the lidar augmentation
    l2i = lidar2image.float()[:, :, None]                     # [B, N, 1, 4, 4]
    cam = _matvec(l2i[..., :3, :3], xyz[:, None]) + l2i[..., :3, 3]  # [B, N, P, 3]
    dist = cam[..., 2]
    z = dist.clamp(1e-5, 1e5)
    uvd = torch.stack([cam[..., 0] / z, cam[..., 1] / z, torch.ones_like(z)], -1)
    ia = img_aug.float()[:, :, None]
    uv = _matvec(ia[..., :3, :3], uvd) + ia[..., :3, 3]
    r, c = uv[..., 1], uv[..., 0]
    on_img = ((r >= 0) & (r < iH) & (c >= 0) & (c < iW) & points_mask[:, None, :].bool()
              & (dist > 0))
    ri = r.int().clamp(0, iH - 1)
    ci = c.int().clamp(0, iW - 1)
    npix = N * iH * iW
    n_off = torch.arange(N, device=points.device)[None, :, None] * (iH * iW)
    idx = torch.where(on_img, ri * iW + ci + n_off, npix).reshape(B, N * P).long()
    out = torch.full((B, npix + 1), float("inf"), device=points.device)  # slot npix: off-image
    out.scatter_reduce_(1, idx, dist.reshape(B, N * P), "amin", include_self=False)
    out = out[:, :npix]
    return torch.where(torch.isinf(out), 0.0, out).view(B, N, iH, iW)


def lss_constants(image_size, feature_size, xbound, ybound, zbound, dbound):
    """(dx, bx, nx, frustum) of an LSS transform: the grid constants of
    ``gen_dx_bx`` and the ``create_frustum`` points [D, fH, fW, 3]."""
    dx, bx, nx = gen_dx_bx(xbound, ybound, zbound)
    return dx, bx, nx, create_frustum(tuple(image_size), tuple(feature_size), dbound)


def build_pool_lut(frustum: torch.Tensor, dx, bx, nx,
                   mats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The pool's intervals for a batch's calibration (``mats`` under the
    batch's key names), on the matrices' device: the ``PoolIntervals``
    fields, plus ``cell_ids`` [B, N*D*fH*fW] int32, each frustum point's
    cell or ``Z*X*Y`` outside the grid (the point -> cell pairing a
    backward pass needs). They depend on the matrices only, so a deployed
    rig computes them once (BEVPoolv2's precompute)."""
    geom = get_geometry(frustum, mats["camera2lidar"], mats["camera_intrinsics"][..., :3, :3],
                        mats["img_aug_matrix"], mats["lidar_aug_matrix"])
    ids, valid = cell_ids_from_geometry(geom, dx, bx, nx)
    num_cells = int(nx[0]) * int(nx[1]) * int(nx[2])
    lut = build_intervals(ids, valid, num_cells)._asdict()
    lut["cell_ids"] = torch.where(valid, ids, num_cells).flatten(1).int()
    return lut


class _BaseLSS(nn.Module):
    """What the LSS transforms share: the grid and frustum constants, the
    pool and the optional strided ``downsample``. A subclass builds its
    nets in ``build_nets`` (registered before ``downsample``, in the
    reference's order), among them ``depthnet``, whose output holds D depth
    logits then C context channels per pixel."""

    def __init__(self, in_channels: int = 256, out_channels: int = 80,
                 image_size: Sequence[int] = (256, 704), feature_size: Sequence[int] = (32, 88),
                 xbound=(-51.2, 51.2, 0.4), ybound=(-51.2, 51.2, 0.4), zbound=(-10.0, 10.0, 20.0),
                 dbound=(1.0, 60.0, 0.5), downsample: int = 1):
        super().__init__()
        self.image_size, self.dbound = tuple(image_size), tuple(dbound)
        self.dx, self.bx, nx, frustum = lss_constants(image_size, feature_size, xbound, ybound,
                                                      zbound, dbound)
        self.nx = tuple(int(n) for n in nx)
        self.register_buffer("frustum", torch.from_numpy(frustum.copy()), persistent=False)
        self.D, self.C = frustum.shape[0], out_channels
        if downsample > 2:
            raise NotImplementedError(f"{type(self).__name__}: downsample {downsample} (the JAX "
                                      "package takes 1 or 2)")
        self.build_nets(in_channels)
        c = out_channels
        self.downsample = (nn.Sequential(*conv_bn_relu(c, c, 3, 1, 1),
                                         *conv_bn_relu(c, c, 3, downsample, 1),
                                         *conv_bn_relu(c, c, 3, 1, 1))
                           if downsample == 2 else nn.Identity())

    def build_nets(self, in_channels: int) -> None:
        raise NotImplementedError

    def pool(self, depth: torch.Tensor, ctx: torch.Tensor,
             mats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """depth [B, N, D, fH, fW], ctx [B, N, fH, fW, C] -> [B, Z*C, X, Y].
        With ``mats["pool_lut"]`` (``runtime/flagship.py:add_pool_lut``) the
        precomputed intervals are used; otherwise ``build_pool_lut`` runs
        here, on the device. Differentiable in depth and ctx
        (``BEVPoolFunction``), on either route."""
        X, Y, Z = self.nx
        lut: Optional[Dict[str, torch.Tensor]] = mats.get("pool_lut")
        if lut is None:
            lut = build_pool_lut(self.frustum, self.dx, self.bx, self.nx, mats)
        elif tuple(lut["cell_ids"].shape) != (depth.shape[0], depth[0].numel()):
            raise ValueError(f"pool_lut: cell_ids {tuple(lut['cell_ids'].shape)} was built "
                             f"for another batch or frustum than depth {tuple(depth.shape)}")
        return BEVPoolFunction.apply(
            depth, ctx, PoolIntervals(*(lut[k] for k in PoolIntervals._fields)), Z, X, Y)

    def to_bev(self, x: torch.Tensor, B: int, mats: Dict[str, torch.Tensor],
               timed=untimed, return_depth: bool = False):
        """The depthnet's output ``x`` [B*N, D+C, fH, fW] -> BEV [B, C, X', Y']:
        the softmax over depth bins and the context channels-last (both fp32
        or wider: K4 is fp32 at any compute dtype), the pool, the BEV map in
        ``x``'s dtype, the downsample, each through ``timed``. With
        ``return_depth``, (BEV, the softmax [B, N, D, fH, fW])."""
        BN, _, fH, fW = x.shape
        N = BN // B

        def split():
            depth = at_least_fp32(x[:, :self.D]).softmax(1).view(B, N, self.D, fH, fW)
            ctx = at_least_fp32(x[:, self.D:]).permute(0, 2, 3, 1).contiguous()
            return depth, ctx.view(B, N, fH, fW, self.C)

        def pool():
            with fp32_region(x):
                return self.pool(depth, ctx, mats).to(x.dtype)

        depth, ctx = timed("depth softmax + ctx channels-last", split)
        bev = timed("bev_pool" if mats.get("pool_lut") is not None else
                    "build_pool_lut + bev_pool", pool)
        bev = timed("downsample", lambda: self.downsample(bev))
        return (bev, depth) if return_depth else bev


@VTRANSFORMS.register
class LSSTransform(_BaseLSS):
    """Camera-only LSS: a 1x1 depthnet on the image features predicts a
    softmax over D depth bins and C context channels; the pool sums depth
    x context per BEV cell; an optional strided downsample."""

    def build_nets(self, in_channels: int) -> None:
        self.depthnet = nn.Conv2d(in_channels, self.D + self.C, 1)

    def forward(self, img_feats: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                mats: Dict[str, torch.Tensor], timed=untimed) -> torch.Tensor:
        """img_feats [B, N, Cin, fH, fW] -> BEV [B, C, X', Y'] (the points are
        not used). ``timed(name, fn)`` runs each piece."""
        B, N, Cin, fH, fW = img_feats.shape
        x = timed("depthnet", lambda: self.depthnet(img_feats.reshape(B * N, Cin, fH, fW)))
        return self.to_bev(x, B, mats, timed)


@VTRANSFORMS.register
class DepthLSSTransform(_BaseLSS):
    """Sparse LiDAR depth through a strided CNN (1 -> 64 channels at 1/8
    resolution), concatenated with the image features; a 3-conv depthnet
    predicts a softmax over D depth bins and C context channels; the pool
    sums depth x context per BEV cell; an optional strided downsample."""

    def build_nets(self, in_channels: int) -> None:
        self.dtransform = nn.Sequential(*conv_bn_relu(1, 8, 1, bias=True),
                                        *conv_bn_relu(8, 32, 5, 4, 2, bias=True),
                                        *conv_bn_relu(32, 64, 5, 2, 2, bias=True))
        self.depthnet = nn.Sequential(
            *conv_bn_relu(in_channels + 64, in_channels, 3, 1, 1, bias=True),
            *conv_bn_relu(in_channels, in_channels, 3, 1, 1, bias=True),
            nn.Conv2d(in_channels, self.D + self.C, 1))

    def forward(self, img_feats: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                mats: Dict[str, torch.Tensor], timed=untimed) -> torch.Tensor:
        """img_feats [B, N, Cin, fH, fW] -> BEV [B, C, X', Y'].
        ``timed(name, fn)`` runs each piece (the profiling tools pass a
        timer)."""
        B, N, Cin, fH, fW = img_feats.shape
        d = timed("rasterize_depth", lambda: rasterize_depth(
            points, points_mask, mats["lidar2image"], mats["img_aug_matrix"],
            mats["lidar_aug_matrix"], self.image_size))
        # the depth image in the weights' dtype: fp32 at either compute dtype, float64 in
        # a model made float64
        d = d.view(B * N, 1, *self.image_size).to(self.dtransform[0].weight.dtype)
        d = timed("dtransform", lambda: self.dtransform(d))
        x = timed("depthnet", lambda: self.depthnet(
            torch.cat([d, img_feats.reshape(B * N, Cin, fH, fW)], 1)))
        return self.to_bev(x, B, mats, timed)
