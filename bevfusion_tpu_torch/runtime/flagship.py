"""Model builders and synthetic inputs for the port's main path.

Counterpart of ``bevfusion_tpu/runtime/flagship.py``. The main path is
the flagship, the fused camera+LiDAR TransFusion detector
(configs/nuscenes/det/transfusion/secfpn/camera+lidar/swint_v0p075/
convfuser.yaml, reference val mAP 68.52 / NDS 71.38), run as eval forward
at batch 1 with the host pooling LUT (``build_flagship``). Its LiDAR
branch and BEV tail alone are TransFusion-L
(configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet_0p075.yaml,
reference val mAP 64.68 / NDS 69.28; ``build_lidar_slice``). The
flagship's training step (``build_flagship(training=True)`` with
``runtime/train.py``) trains on the same synthetic batch plus random
ground-truth boxes. The synthetic inputs are byte-equal to the JAX
package's.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Config, load_config
from ..devices import resolve_device
from ..models import build_model
from ..models.sparse_encoder import SparseConv3d
from ..models.vtransforms import build_pool_lut, lss_constants

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIDAR_SLICE_CONFIG = os.path.join(
    REPO_ROOT, "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet_0p075.yaml")
FLAGSHIP_CONFIG = os.path.join(
    REPO_ROOT, "configs/nuscenes/det/transfusion/secfpn/camera+lidar/swint_v0p075/convfuser.yaml")


def synthetic_calibration(B: int, N: int, image_size) -> Dict[str, np.ndarray]:
    """A nuScenes-like rig of N cameras in a horizontal ring, looking
    outward, focal 0.6 * iW (float32 numpy, byte-equal to the JAX
    package's, whose seed argument draws nothing): the camera matrices
    under the batch's key names."""
    iH, iW = image_size
    intr = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    intr[:, :, 0, 0] = intr[:, :, 1, 1] = 0.6 * iW
    intr[:, :, 0, 2] = iW / 2
    intr[:, :, 1, 2] = iH / 2

    cam2lidar = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    for n in range(N):
        yaw = 2 * np.pi * n / N
        # x_cam = right, y_cam = down, z_cam = forward
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        cam2lidar[:, n, :3, :3] = np.stack([right, -down, fwd], axis=1)
        cam2lidar[:, n, :3, 3] = fwd * 1.5 + np.array([0, 0, 1.6])

    lidar2cam = np.linalg.inv(cam2lidar)
    eye_b = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    return {
        "camera_intrinsics": intr,
        "camera2lidar": cam2lidar,
        "lidar2camera": lidar2cam.astype(np.float32),
        "lidar2image": np.einsum("bnij,bnjk->bnik", intr, lidar2cam).astype(np.float32),
        "camera2ego": cam2lidar.copy(),
        "lidar2ego": eye_b,
        "img_aug_matrix": np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1)),
        "lidar_aug_matrix": eye_b,
    }


def synthetic_lidar_scan(num_points: int, pcr, seed: int = 0, n_beams: int = 32,
                         n_sweeps: int = 10):
    """Ring-structured synthetic lidar (byte-equal to the JAX package's):
    a beam-model scan of 10 aggregated HDL-32E-like sweeps with ground
    rings and car-sized obstacles, so site density falls with range as in
    real nuScenes scans. Returns (points [num_points, 5] float32
    (x, y, z, intensity, time_lag), mask [num_points] bool); points
    outside the cloud range are masked."""
    rng = np.random.RandomState(seed)
    pcr = np.asarray(pcr, np.float32)
    h_lidar = 1.84  # nuScenes LIDAR_TOP mount height
    elev = np.deg2rad(np.linspace(-30.67, 10.67, n_beams)).astype(np.float32)

    rays_per_sweep = max(num_points // max(n_sweeps, 1), n_beams)
    n_az = max(rays_per_sweep // n_beams, 8)

    n_obs = 48
    obs_r = rng.uniform(5.0, 52.0, n_obs).astype(np.float32)
    obs_az = rng.uniform(-np.pi, np.pi, n_obs).astype(np.float32)
    obs_rad = rng.uniform(0.8, 2.4, n_obs).astype(np.float32)
    obs_h = rng.uniform(1.4, 3.2, n_obs).astype(np.float32)

    pts, lags = [], []
    ego_speed = 4.0  # m/s, sweeps displace backwards along x
    for s in range(n_sweeps):
        az = (np.linspace(-np.pi, np.pi, n_az, endpoint=False)
              + rng.uniform(0, 2 * np.pi / n_az)).astype(np.float32)
        A, E = np.meshgrid(az, elev)
        A, E = A.reshape(-1), E.reshape(-1)
        rng_ground = np.where(
            E < -0.008, h_lidar / np.tan(np.maximum(-E, 1e-3)), 1e4).astype(np.float32)
        dalt = np.abs(((A[:, None] - obs_az[None, :]) + np.pi) % (2 * np.pi) - np.pi)
        ang_rad = obs_rad[None, :] / np.maximum(obs_r[None, :], 1.0)
        z_at = -h_lidar + obs_r[None, :] * np.tan(E)[:, None]
        hit = (dalt < ang_rad) & (z_at > -h_lidar) & (z_at < -h_lidar + obs_h)
        rng_obs = np.where(hit, obs_r[None, :], 1e4).min(axis=1)

        r = np.minimum(rng_ground, rng_obs)
        r = r * (1 + rng.normal(0, 0.01, r.shape).astype(np.float32))
        x = r * np.cos(E) * np.cos(A) - ego_speed * 0.05 * s
        y = r * np.cos(E) * np.sin(A)
        z = -h_lidar + r * np.sin(E) + rng.normal(0, 0.02, r.shape)
        inten = rng.rand(r.shape[0]).astype(np.float32)
        pts.append(np.stack([x, y, z, inten], -1).astype(np.float32))
        lags.append(np.full((r.shape[0], 1), 0.05 * s, np.float32))

    pts = np.concatenate(pts)
    pts = np.concatenate([pts, np.concatenate(lags)], -1)
    in_range = (
        (pts[:, 0] >= pcr[0]) & (pts[:, 0] < pcr[3])
        & (pts[:, 1] >= pcr[1]) & (pts[:, 1] < pcr[4])
        & (pts[:, 2] >= pcr[2]) & (pts[:, 2] < pcr[5]))
    pts = pts[in_range]
    rng.shuffle(pts)
    n = min(len(pts), num_points)
    out = np.zeros((num_points, 5), np.float32)
    out[:n] = pts[:n]
    mask = np.zeros((num_points,), bool)
    mask[:n] = True
    return out, mask


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, SparseConv3d):  # [kx, ky, kz, Cin, Cout]
        return weight.numel() // weight.shape[-1]
    if isinstance(module, nn.ConvTranspose2d):  # [Cin, Cout, k, k] with k == stride
        return weight.shape[0]
    return weight[0].numel()  # [out, in, ...]


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded ``torch.Generator``: He-normal weights,
    small biases, and randomised BatchNorm / LayerNorm affines and running
    statistics, so every eval normalisation does real work."""
    g = torch.Generator().manual_seed(seed)

    def fill(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    for mod in model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            fill(mod.weight, 0.1, 1.0)
            fill(mod.bias, 0.1)
            fill(mod.running_mean, 0.1)
            mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
        elif isinstance(mod, nn.LayerNorm):
            fill(mod.weight, 0.1, 1.0)
            fill(mod.bias, 0.1)
        else:
            for p in mod.parameters(recurse=False):
                std = 0.1 if p.dim() == 1 else (2.0 / _fan_in(mod, p)) ** 0.5
                fill(p, std)
    return model


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """``batch`` with every tensor (also those of ``pool_lut``) on ``device``."""
    return {k: batch_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in batch.items()}


def synthetic_batch(cfg, B: int = 1, num_points: int = 200000, num_gt: int = 64,
                    seed: int = 0, training: bool = False) -> Dict[str, torch.Tensor]:
    """A batch of CPU tensors, byte-equal to the JAX package's
    ``synthetic_batch`` (scan lidar): B beam-model scans, six images
    ``img [B, 6, 3, iH, iW]`` (drawn NHWC as the JAX package draws them,
    then transposed to NCHW) and ``synthetic_calibration``; with
    ``training``, ``num_gt`` random boxes per sample (``gt_boxes [B, G, 9]``,
    ``gt_labels``, ``gt_valid``), drawn from the same ``RandomState`` in the
    same order."""
    rng = np.random.RandomState(seed)
    iH, iW = cfg.image_size
    N = 6
    pm = [synthetic_lidar_scan(num_points, cfg.point_cloud_range, seed=seed + b)
          for b in range(B)]
    img = rng.rand(B, N, iH, iW, 3).astype(np.float32)
    batch = {"img": np.ascontiguousarray(img.transpose(0, 1, 4, 2, 3)),
             "points": np.stack([p for p, _ in pm]),
             "points_mask": np.stack([m for _, m in pm])}
    batch.update(synthetic_calibration(B, N, (iH, iW)))
    if training:
        G = num_gt
        batch["gt_boxes"] = np.concatenate([
            rng.uniform(-50, 50, (B, G, 2)), rng.uniform(-3, 1, (B, G, 1)),
            rng.uniform(0.5, 4, (B, G, 3)), rng.uniform(-np.pi, np.pi, (B, G, 1)),
            rng.uniform(-2, 2, (B, G, 2))], -1).astype(np.float32)
        batch["gt_labels"] = rng.randint(0, 10, (B, G)).astype(np.int32)
        batch["gt_valid"] = np.ones((B, G), bool)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def add_pool_lut(cfg, batch: Dict[str, Any]) -> Dict[str, Any]:
    """``batch`` with ``pool_lut``, the pooling intervals for its
    calibration (``models/vtransforms.py:build_pool_lut``), built on the
    batch's device. A deployed rig computes it once; without an LSS
    vtransform, a no-op."""
    vt = (cfg.model.get("encoders", {}).get("camera") or {}).get("vtransform") or {}
    if "xbound" not in vt:
        return batch
    dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                        vt["ybound"], vt["zbound"], vt["dbound"])
    frustum = torch.from_numpy(frustum).to(batch["camera2lidar"].device)
    return dict(batch, pool_lut=build_pool_lut(frustum, dx, bx, nx, batch))


def build_lidar_slice(device="cuda", num_points: int = 120000,
                      seed: int = 0) -> Tuple[Config, nn.Module, Dict[str, torch.Tensor]]:
    """TransFusion-L (voxelnet_0p075) at full width with seeded random
    weights on ``device`` (the card unless the caller passes ``"cpu"``), in
    eval mode, and a batch of one 120k-point scan (the point count
    ``bench.py`` drives)."""
    dev = resolve_device(device)
    cfg = load_config(LIDAR_SLICE_CONFIG)
    model = init_weights(build_model(cfg.model, "cpu"), seed).to(dev)
    points, mask = synthetic_lidar_scan(num_points, cfg.point_cloud_range, seed=seed)
    batch = {"points": torch.from_numpy(points)[None].to(dev),
             "points_mask": torch.from_numpy(mask)[None].to(dev)}
    return cfg, model, batch


def build_flagship(device="cuda", num_points: int = 120000, seed: int = 0,
                   training: bool = False) -> Tuple[Config, nn.Module, Dict[str, Any]]:
    """The fused flagship (swint_v0p075/convfuser.yaml) at full width with
    seeded random weights on ``device`` (the card unless the caller passes
    ``"cpu"``), and a batch of one sample (six 256x704 images, one scan of
    ``num_points``, the synthetic rig) with its pooling LUT, built on the
    CPU (``bench.py``'s main path). With ``training`` the model is in
    training mode and the batch carries 64 random ground-truth boxes."""
    dev = resolve_device(device)
    cfg = load_config(FLAGSHIP_CONFIG)
    model = init_weights(build_model(cfg.model, "cpu"), seed).to(dev).train(training)
    batch = add_pool_lut(cfg, synthetic_batch(cfg, B=1, num_points=num_points, seed=seed,
                                              training=training))
    return cfg, model, batch_to(batch, dev)
