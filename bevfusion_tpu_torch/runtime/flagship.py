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
ground-truth boxes and the targets ``add_train_targets`` makes (the
depth images, map masks). ``build_flagship(config_path=...)`` builds any other
config the port runs the same way, among them the three BEV
map-segmentation configs (``SEG_CONFIGS``), the three camera-only
CenterHead detectors (``DET_CAMERA_CONFIGS``) and the two pillar configs
(``PILLAR_CONFIGS``: PointPillars, camera + radar). The synthetic inputs
are byte-equal to the JAX package's; the radar scan
(``synthetic_radar_scan``), which the JAX package does not make, is the
port's own.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Config, load_config
from ..data.transforms import GTDepth
from ..devices import resolve_device
from ..models import build_model
from ..models.sparse_encoder import SparseConv3d
from ..models.vtransforms import build_pool_lut, lss_constants

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIDAR_SLICE_CONFIG = os.path.join(
    REPO_ROOT, "configs/nuscenes/det/transfusion/secfpn/lidar/voxelnet_0p075.yaml")
FLAGSHIP_CONFIG = os.path.join(
    REPO_ROOT, "configs/nuscenes/det/transfusion/secfpn/camera+lidar/swint_v0p075/convfuser.yaml")
# the BEV map-segmentation configs: fused, LiDAR-only and camera-only (reference val
# mIoU 62.95, 48.56 and 57.09, from each file's header)
SEG_CONFIGS = {name: os.path.join(REPO_ROOT, "configs/nuscenes/seg", f"{name}.yaml")
               for name in ("fusion-bev256d2-lss", "lidar-centerpoint-bev128", "camera-bev256d2")}
# the camera-only CenterHead detectors: Swin-T + GeneralizedLSSFPN + LSS at 0.4 m (reference
# val mAP 35.56 / NDS 41.21, from the file's header), ResNet-50 + SECONDFPN + LSS at 0.8 m, and
# the same with BEVDepth's AwareBEVDepth; each a GeneralizedResNet + LSSFPN decoder
DET_CAMERA_CONFIGS = {
    name: os.path.join(REPO_ROOT, "configs/nuscenes/det/centerhead/lssfpn/camera/256x704", path)
    for name, path in (("swint", "swint/default.yaml"), ("resnet", "resnet/default.yaml"),
                       ("bevdepth", "resnet/bevdepth.yaml"))}
# the pillar-encoder configs: LiDAR-only PointPillars TransFusion (a pillar feature net and a
# dense scatter at 0.2 m), and camera + radar CenterHead (ResNet-50 + SECONDFPN + LSS at 0.8 m
# beside a radar pillar branch, ConvFuser, GeneralizedResNet + LSSFPN)
PILLAR_CONFIGS = {
    "pointpillars": os.path.join(REPO_ROOT,
                                 "configs/nuscenes/det/transfusion/secfpn/lidar/pointpillars.yaml"),
    "camera+radar": os.path.join(
        REPO_ROOT, "configs/nuscenes/det/centerhead/lssfpn/camera+radar/resnet50/default.yaml")}
# its AwareDBEVDepth variant, which neither package builds (the depth branch at stride 8
# against stride-16 image features; ROADMAP Queue 3)
DLSS_CONFIG = os.path.join(REPO_ROOT,
                           "configs/nuscenes/det/centerhead/lssfpn/camera+radar/resnet50/dlss.yaml")
# (mean, std) that each CenterHead branch's maps are moved to, by an affine map of its last
# conv's output channels, when a check needs real work from the decode and the NMS: at random
# init the maps run to 1e4 (the camera backbone's residual sums), where every box falls outside
# the post-center range or overflows exp(dim); these give scores spread over (0, 1) and boxes
# of 0.5-3 m near their cells
DET_HEAD_MODERATE = {"heatmap": (-1.0, 1.5), "reg": (0.5, 0.3), "height": (0.0, 1.0),
                     "dim": (0.0, 0.4), "rot": (0.0, 1.0), "vel": (0.0, 1.0)}


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


def synthetic_radar_scan(num_points: int = 300, pcr=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                         channels: int = 45, seed: int = 0):
    """A seeded radar scan of ``num_points`` slots (the JAX loader's
    ``max_num``, 300), 85% of them filled: returns from 24 objects (70%,
    1 m clusters, 2-50 m out) and clutter (30%), xyz in the cloud range near
    the ground (the radars sit 1.3 m below the LiDAR), then RCS (dBsm),
    the velocity and the ego-compensated velocity (m/s; static returns
    near 0, movers up to 15), the sweep's time lag (0 / 0.07 / 0.13 s),
    then one-hot groups of 0 / 1 in the nuScenes radar's encoding (dynamic
    property 8, ambiguity 5, invalid state 18, PDH ordinal 7, a filter
    flag 1) for the remaining channels. Returns (points [num_points,
    channels] float32, mask [num_points] bool); padded slots are 0."""
    rng = np.random.RandomState(seed)
    pcr = np.asarray(pcr, np.float32)
    n = int(0.85 * num_points)
    n_obj = 24
    az, rad = rng.uniform(-np.pi, np.pi, n_obj), rng.uniform(2.0, 50.0, n_obj)
    centre = np.stack([rad * np.cos(az), rad * np.sin(az)], -1)
    speed = np.where(rng.rand(n_obj) < 0.4, rng.uniform(-15, 15, n_obj), 0.0)
    on_obj = rng.rand(n) < 0.7
    obj = rng.randint(0, n_obj, n)
    xy = np.where(on_obj[:, None], centre[obj] + rng.normal(0, 1.0, (n, 2)),
                  rng.uniform(pcr[:2] * 0.98, pcr[3:5] * 0.98, (n, 2)))
    xy = np.clip(xy, pcr[:2] + 0.01, pcr[3:5] - 0.01)
    z = np.clip(rng.normal(-1.3, 0.3, n), pcr[2] + 0.01, pcr[5] - 0.01)
    heading = np.arctan2(xy[:, 1], xy[:, 0])
    v = np.where(on_obj, speed[obj], 0.0) + rng.normal(0, 0.2, n)
    vel = np.stack([v * np.cos(heading), v * np.sin(heading)], -1)
    comp = vel + rng.normal(0, 0.1, (n, 2))
    lag = rng.randint(0, 3, n) * 0.065  # three sweeps
    dense = np.concatenate([xy, z[:, None], rng.normal(5.0, 8.0, (n, 1)), vel, comp,
                            lag[:, None]], -1)
    groups = []
    for size in (8, 5, 18, 7, 1):
        onehot = np.zeros((n, size))
        onehot[np.arange(n), rng.randint(0, size, n)] = 1.0
        groups.append(onehot)
    feats = np.concatenate([dense] + groups, -1)[:, :channels]
    out = np.zeros((num_points, channels), np.float32)
    out[:n, :feats.shape[1]] = feats
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
    same order; with a radar branch, ``radar [B, 300, C]`` and ``radar_mask``
    (``synthetic_radar_scan``, C the radar feature net's ``in_channels``)."""
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
    radar = (cfg.model.get("encoders") or {}).get("radar")
    if radar:
        rm = [synthetic_radar_scan(pcr=radar["voxelize"]["point_cloud_range"],
                                   channels=radar["backbone"]["pts_voxel_encoder"]["in_channels"],
                                   seed=seed + b) for b in range(B)]
        batch["radar"] = np.stack([p for p, _ in rm])
        batch["radar_mask"] = np.stack([m for _, m in rm])
    if training:
        G = num_gt
        batch["gt_boxes"] = np.concatenate([
            rng.uniform(-50, 50, (B, G, 2)), rng.uniform(-3, 1, (B, G, 1)),
            rng.uniform(0.5, 4, (B, G, 3)), rng.uniform(-np.pi, np.pi, (B, G, 1)),
            rng.uniform(-2, 2, (B, G, 2))], -1).astype(np.float32)
        batch["gt_labels"] = rng.randint(0, 10, (B, G)).astype(np.int32)
        batch["gt_valid"] = np.ones((B, G), bool)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def add_train_targets(cfg, batch: Dict[str, torch.Tensor], seed: int = 0
                      ) -> Dict[str, torch.Tensor]:
    """``batch`` (``synthetic_batch``'s, CPU tensors) with the training
    targets that the heads and the depth loss read beside the boxes:
    ``depths`` [B, N, iH, iW], each sample's valid points projected into its
    cameras by ``GTDepth`` (with the options of the config's
    ``train_pipeline`` entry: nuScenes' keep the keyframe's points only);
    and where the config has a map head, seeded random ``gt_masks_bev``
    [B, classes, X, Y] (30% of the cells set) on the head's output grid. The
    batch's own arrays are left as they are."""
    opts = next((dict(t) for t in cfg.get("train_pipeline") or []
                 if t.get("type") == "GTDepth"), {})
    opts.pop("type", None)
    gt_depth = GTDepth(**opts)
    depths = []
    for b in range(batch["img"].shape[0]):
        pts = batch["points"][b][batch["points_mask"][b]].numpy()
        data = {"points": pts, "img": list(batch["img"][b].numpy().transpose(0, 2, 3, 1)),
                **{k: batch[k][b].numpy() for k in ("lidar2image", "img_aug_matrix",
                                                     "lidar_aug_matrix")}}
        depths.append(gt_depth(data)["depths"])
    out = dict(batch, depths=torch.from_numpy(np.stack(depths)))
    head = (cfg.model.get("heads") or {}).get("map")
    if head:
        grid = [round((hi - lo) / step) for lo, hi, step in head["grid_transform"]["output_scope"]]
        rng = np.random.RandomState(seed + 7)  # apart from synthetic_batch's, the JAX one's
        masks = rng.rand(batch["img"].shape[0], len(head["classes"]), *grid) < 0.3
        out["gt_masks_bev"] = torch.from_numpy(masks.astype(np.float32))
    return out


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
                   training: bool = False, config_path: Optional[str] = None
                   ) -> Tuple[Config, nn.Module, Dict[str, Any]]:
    """The fused flagship (swint_v0p075/convfuser.yaml), or the config at
    ``config_path``, at full width with seeded random weights on ``device``
    (the card unless the caller passes ``"cpu"``), and a batch of one sample
    (six 256x704 images, one scan of ``num_points``, the synthetic rig, and
    ``synthetic_radar_scan`` where the config has a radar branch) with
    the pooling LUT where the config has an LSS camera branch, built on the
    CPU (``bench.py``'s main path). With ``training`` the model is in
    training mode and the batch carries 64 random ground-truth boxes for
    the object head and ``add_train_targets``'s depth images and map
    masks."""
    dev = resolve_device(device)
    cfg = load_config(config_path or FLAGSHIP_CONFIG)
    model = init_weights(build_model(cfg.model, "cpu"), seed).to(dev).train(training)
    batch = synthetic_batch(cfg, B=1, num_points=num_points, seed=seed, training=training)
    if training:
        batch = add_train_targets(cfg, batch, seed)
    return cfg, model, batch_to(add_pool_lut(cfg, batch), dev)
