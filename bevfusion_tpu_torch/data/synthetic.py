"""A seeded nuScenes-format dataset on disk, for driving the eval and train
entry points (``tools/test.py``, ``tools/train.py``) without the real
dataset.

``write_synthetic_nuscenes`` writes what the converter writes for
nuScenes (``nuscenes_infos_val.pkl``, and ``nuscenes_infos_train.pkl``
when asked for a train split) and the files it points at: per
sample a keyframe and its sweeps as ``.bin`` point clouds (float32 x, y,
z, intensity, ring), each scan a beam model (``runtime/flagship.py:
synthetic_lidar_scan``) seen from the sweep's own pose, and one PNG a
camera. The cameras are a ring (``camera_ring``) with each sample's
extrinsics moved by a small seeded rotation and translation
(``jittered_rig``), so no frustum point sits on a BEV cell boundary. The
ground truth is a few random boxes; no sample has a map ``location``, so
map masks are all zero (``LoadBEVSegmentation``).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Sequence

import numpy as np

from ..core.box_np import points_in_rbbox
from ..runtime.flagship import synthetic_lidar_scan

__all__ = ["CAMERAS", "camera_ring", "jittered_rig", "matrix_to_quaternion",
           "write_synthetic_nuscenes"]

CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK", "CAM_BACK_LEFT",
           "CAM_BACK_RIGHT")  # the converter's order
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
           "bicycle", "pedestrian", "traffic_cone")
LIDAR2EGO_T = (0.94, 0.0, 1.84)  # nuScenes' LIDAR_TOP mount


def _rotation(axis_angle: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle [3] -> rotation [3, 3] (float64)."""
    theta = np.linalg.norm(axis_angle)
    k = axis_angle / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def jittered_rig(mats: Dict[str, np.ndarray], seed: int, rot_std: float = 0.02,
                 trans_std: float = 0.05) -> Dict[str, np.ndarray]:
    """``mats`` (numpy camera matrices under the batch's key names, [B, N,
    4, 4]) with every camera2lidar moved by a small seeded rotation and
    translation, and lidar2camera / lidar2image / camera2ego made
    consistent with it (the same draws as the tests' helper of that name)."""
    rng = np.random.RandomState(seed)
    c2l = np.array(mats["camera2lidar"], np.float64)
    B, N = c2l.shape[:2]
    for b in range(B):
        for n in range(N):
            c2l[b, n, :3, :3] = _rotation(rng.normal(0, rot_std, 3)) @ c2l[b, n, :3, :3]
            c2l[b, n, :3, 3] += rng.normal(0, trans_std, 3)
    l2c = np.linalg.inv(c2l)
    intr = np.array(mats["camera_intrinsics"], np.float64)
    out = dict(mats)
    out.update(camera2lidar=c2l.astype(np.float32), camera2ego=c2l.astype(np.float32),
               lidar2camera=l2c.astype(np.float32),
               lidar2image=np.einsum("bnij,bnjk->bnik", intr, l2c).astype(np.float32))
    return out


def camera_ring(N: int, image_hw: Sequence[int], focal: float = 0.6) -> Dict[str, np.ndarray]:
    """N cameras in a horizontal ring around the LiDAR, 1 m out and 0.3 m
    below it, looking outward (camera frame x right, y down, z forward):
    ``camera_intrinsics`` and ``camera2lidar`` [1, N, 4, 4] (float32), the
    focal length ``focal`` x the image width, the principal point at the
    centre. (``synthetic_calibration``'s ring, which the two packages share
    byte for byte, has x left and y up: its ground lies in the rows that the
    nuScenes crop takes away.)"""
    H, W = image_hw
    intr = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = focal * W
    intr[..., 0, 2], intr[..., 1, 2] = W / 2, H / 2
    c2l = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
    for n in range(N):
        yaw = 2 * np.pi * n / N
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        c2l[0, n, :3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        c2l[0, n, :3, 3] = fwd + np.array([0.0, 0.0, -0.3])
    return {"camera_intrinsics": intr, "camera2lidar": c2l}


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (w, x, y, z), w >= 0 (the inverse of
    ``data/nuscenes.py:quaternion_to_matrix``)."""
    R = np.asarray(R, np.float64)
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def _yaw_quaternion(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _scan(n: int, pcr, seed: int) -> np.ndarray:
    """``n`` points [n, 5] of one beam-model sweep inside ``pcr``: x, y, z,
    intensity, and a ring index 0-31 where nuScenes keeps the beam's (drawn
    at random: the sweep loader writes the time lag over it)."""
    pts, mask = synthetic_lidar_scan(4 * n, pcr, seed=seed, n_sweeps=1)
    pts = pts[mask]
    if len(pts) < n:
        raise ValueError(f"the scan holds {len(pts)} points in {list(pcr)}, fewer than {n}")
    pts = pts[:n].copy()
    pts[:, 4] = np.random.RandomState(seed).randint(0, 32, n)
    return pts


def _image(rng: np.random.RandomState, hw: Sequence[int], path: str) -> None:
    """A seeded RGB image (4 x 4 blocks of noise, so the PNG stays small) at ``path``."""
    from PIL import Image

    H, W = hw
    small = rng.randint(0, 256, ((H + 3) // 4, (W + 3) // 4, 3)).astype(np.uint8)
    img = np.repeat(np.repeat(small, 4, 0), 4, 1)[:H, :W]
    Image.fromarray(np.ascontiguousarray(img)).save(path, compress_level=1)


def write_synthetic_nuscenes(root: str, num_samples: int = 4, num_cameras: int = 6,
                             image_hw: Sequence[int] = (900, 1600),
                             points_per_sweep: int = 30000, num_sweeps: int = 9,
                             point_cloud_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
                             num_gt: int = 6, seed: int = 0, rig_seed: int = 0,
                             focal: float = 0.6, train_samples: int = 0) -> str:
    """Write ``num_samples`` samples under ``root`` and their info pkl;
    returns the pkl's path (``root/nuscenes_infos_val.pkl``). With
    ``train_samples`` > 0 it also writes that many samples of a train split
    (``root/nuscenes_infos_train.pkl``, tokens ``synthetic_train_<seed + 1>_<i>``),
    drawn from ``seed + 1`` in the same way, but
    each box is placed around a keyframe point (its bottom 0.1-0.5 m below
    it) and ``num_lidar_pts`` counts the keyframe points inside it, so the
    GT database (``data/converter.py:create_gt_database``) has crops to
    paste.

    Each sample has ``num_cameras`` cameras of ``image_hw`` (focal length
    ``focal`` x the image width, the principal point at the centre; the
    rig jittered with ``rig_seed + sample``), a keyframe and ``num_sweeps``
    sweeps of ``points_per_sweep`` points inside ``point_cloud_range``
    (the sweeps 50 ms apart, the ego driving 4 m/s along x and turning
    0.02 rad/s), and ``num_gt`` boxes with velocities. Everything is drawn
    from ``seed``."""
    root = os.path.abspath(root)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    kw = dict(num_cameras=num_cameras, image_hw=image_hw, points_per_sweep=points_per_sweep,
              num_sweeps=num_sweeps, point_cloud_range=point_cloud_range, num_gt=num_gt,
              rig_seed=rig_seed, focal=focal)
    if train_samples > 0:
        _write_split(root, "train", f"synthetic_train_{seed + 1}", train_samples,
                     seed=seed + 1, **kw)
    return _write_split(root, "val", f"synthetic_{seed}", num_samples, seed=seed, **kw)


def _write_split(root: str, split: str, prefix: str, num_samples: int, num_cameras: int,
                 image_hw: Sequence[int], points_per_sweep: int, num_sweeps: int,
                 point_cloud_range, num_gt: int, seed: int, rig_seed: int,
                 focal: float) -> str:
    """``write_synthetic_nuscenes``' samples of one split, their tokens
    ``<prefix>_<i>``; returns the path of ``nuscenes_infos_<split>.pkl``."""
    H, W = image_hw
    pcr = np.asarray(point_cloud_range, np.float32)
    rng = np.random.RandomState(seed)
    base = camera_ring(num_cameras, (H, W), focal)
    infos = []
    for i in range(num_samples):
        token = f"{prefix}_{i:04d}"
        rig = jittered_rig(base, rig_seed + i)
        timestamp = 1_530_000_000_000_000 + 500_000 * i  # 2 Hz keyframes, microseconds
        lidar_path = os.path.join(root, "samples", f"{token}_lidar.bin")
        keyframe = _scan(points_per_sweep, pcr, seed * 1000 + 100 * i)
        keyframe.tofile(lidar_path)
        sweeps = []
        for j in range(1, num_sweeps + 1):
            path = os.path.join(root, "samples", f"{token}_sweep{j}.bin")
            _scan(points_per_sweep, pcr, seed * 1000 + 100 * i + j).tofile(path)
            yaw = -0.001 * j
            sweeps.append({
                "data_path": path, "timestamp": timestamp - 50_000 * j,
                "sensor2lidar_rotation": _rotation(np.array([0.0, 0.0, yaw])).astype(np.float32),
                "sensor2lidar_translation": np.array([-0.2 * j, 0.0, 0.0], np.float32)})
        cams = {}
        for n, name in enumerate(CAMERAS[:num_cameras]):
            path = os.path.join(root, "samples", f"{token}_{name}.png")
            _image(rng, (H, W), path)
            c2l = rig["camera2lidar"][0, n].astype(np.float64)
            c2e = c2l.copy()
            c2e[:3, 3] += LIDAR2EGO_T
            cams[name] = {
                "data_path": path, "cam_intrinsic": rig["camera_intrinsics"][0, n, :3, :3],
                "sensor2lidar_rotation": c2l[:3, :3], "sensor2lidar_translation": c2l[:3, 3],
                "sensor2ego_rotation": matrix_to_quaternion(c2e[:3, :3]).tolist(),
                "sensor2ego_translation": c2e[:3, 3].tolist(),
                "timestamp": timestamp}
        boxes = np.concatenate([
            rng.uniform(0.6 * pcr[0], 0.6 * pcr[3], (num_gt, 2)), rng.uniform(-2, 0, (num_gt, 1)),
            rng.uniform(0.5, 4, (num_gt, 3)), rng.uniform(-np.pi, np.pi, (num_gt, 1))],
            -1).astype(np.float32)
        names = np.array([CLASSES[k] for k in rng.randint(0, len(CLASSES), num_gt)])
        velocity = rng.uniform(-3, 3, (num_gt, 2)).astype(np.float32)
        num_pts = rng.randint(1, 200, num_gt)
        if split == "train":  # each box around a keyframe point, so the GT database gets crops
            near = np.flatnonzero((np.abs(keyframe[:, :2]) < 0.6 * pcr[3:5]).all(1))
            at = keyframe[rng.choice(near, num_gt, replace=False), :3]
            boxes[:, :2] = at[:, :2] + rng.uniform(-0.3, 0.3, (num_gt, 2))
            boxes[:, 2] = at[:, 2] - rng.uniform(0.1, 0.5, num_gt)
            num_pts = points_in_rbbox(keyframe, boxes).sum(0)
        infos.append({
            "token": token, "lidar_path": lidar_path, "sweeps": sweeps, "cams": cams,
            "timestamp": timestamp,
            "lidar2ego_translation": list(LIDAR2EGO_T), "lidar2ego_rotation": [1.0, 0, 0, 0],
            "ego2global_translation": [600.0 + 2.0 * i, 1600.0, 0.0],
            "ego2global_rotation": _yaw_quaternion(0.3 + 0.01 * i),
            "gt_boxes": boxes, "gt_names": names, "gt_velocity": velocity,
            "num_lidar_pts": num_pts, "valid_flag": np.ones(num_gt, bool)})
    ann_file = os.path.join(root, f"nuscenes_infos_{split}.pkl")
    with open(ann_file, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "v1.0-trainval"}}, f)
    return ann_file
