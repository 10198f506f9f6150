"""File-loading pipeline steps (numpy, host-side).

A copy of ``bevfusion_tpu/data/loading.py``, held to it by
tests/test_torch_data.py. Behavioral reference:
mmdet3d/datasets/pipelines/loading.py — LoadMultiViewImageFromFiles
(:22), LoadPointsFromFile (:317, 5-dim xyzir), LoadPointsFromMultiSweeps
(:87, 9 sweeps + time-lag dim, remove_close, pad empty),
LoadAnnotations3D (:438), LoadBEVSegmentation (:244-313, nuScenes map
masks). Beam reduction matches loading_utils.py:58+.

One step differs in how, not in what: the JAX package moves each sweep
into the keyframe's frame with its native host library
(``bevfusion_tpu/native``, a C++ loop); ``_transform_sweep_points`` here
does the same float32 operations in the same order in numpy, so the two
agree bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ..core.box_np import LiDARBoxes3D
from ..registry import PIPELINES
from .points import LiDARPoints

__all__ = [
    "LoadMultiViewImageFromFiles", "LoadPointsFromFile",
    "LoadPointsFromMultiSweeps", "LoadAnnotations3D", "LoadBEVSegmentation",
    "load_augmented_point_cloud", "reduce_lidar_beams",
]


def _imread(path: str) -> np.ndarray:
    from PIL import Image  # available via torchvision deps

    return np.asarray(Image.open(path).convert("RGB"))


def _load_points_bin(path: str, load_dim: int) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).reshape(-1, load_dim)
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, load_dim)


def _transform_sweep_points(pts: np.ndarray, rot: np.ndarray, trans: np.ndarray,
                            time_lag: float) -> np.ndarray:
    """A sweep's points [P, dim] in the keyframe's LiDAR frame: xyz through
    the 3x3 ``rot`` and ``trans``, the other columns kept, column 4 (where
    there is one) set to ``time_lag``. Each coordinate is the float32 sum
    ``((r0 * x + r1 * y) + r2 * z) + t``, as the JAX package's native loop
    (``bevfusion_tpu/native/csrc/host_ops.cpp:transform_sweep_points``)
    computes it."""
    pts = np.ascontiguousarray(pts, np.float32)
    rot = np.asarray(rot, np.float32)
    trans = np.asarray(trans, np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    out = pts.copy()
    for i in range(3):
        out[:, i] = rot[i, 0] * x + rot[i, 1] * y + rot[i, 2] * z + trans[i]
    if out.shape[1] >= 5:
        out[:, 4] = np.float32(time_lag)
    return out


def load_augmented_point_cloud(path: str, virtual: bool = False,
                               reduce_beams: int = 32) -> np.ndarray:
    """MVP / PointPainting augmented point cloud (file-layout contract
    from the reference, loading_utils.py:9-55): next to the raw .bin at
    <root>/<a>/<b>/<file>, a painted-points dict lives at
    <root>/virtual_points/<a>/<b>_VIRTUAL[_<K>BEAMS]/<file>.pkl.npy with
    keys real_points [Nr, Dp], virtual_points [Nv, Dp-1] (no reflectance)
    and real_points_indice [Nr].

    Output columns: raw 5-dim points are widened with ones to the painted
    width + 1 "realness" flag; painted real points (flag 0) overwrite
    their raw rows by index; with ``virtual`` the virtual points (zero
    reflectance inserted at column 3, flag -1) are appended.
    """
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    parts = path.split("/")
    suffix = "_VIRTUAL" if reduce_beams == 32 else f"_VIRTUAL_{reduce_beams}BEAMS"
    aug_path = os.path.join(
        *parts[:-3], "virtual_points", parts[-3], parts[-2] + suffix,
        parts[-1] + ".pkl.npy")
    if path.startswith(os.sep):
        aug_path = os.sep + aug_path
    data = np.load(aug_path, allow_pickle=True).item()

    real = np.asarray(data["real_points"], np.float32)
    virt = np.asarray(data["virtual_points"], np.float32)
    # virtual points carry no reflectance: insert a zero column at dim 3
    virt = np.concatenate(
        [virt[:, :3], np.zeros((len(virt), 1), np.float32), virt[:, 3:]], axis=1)

    width = real.shape[1] + 1  # painted dims + realness flag
    out = np.concatenate(
        [points, np.ones((len(points), width - points.shape[1]), np.float32)],
        axis=1)
    real = np.concatenate([real, np.zeros((len(real), 1), np.float32)], axis=1)
    idx = np.asarray(data["real_points_indice"], np.int64)
    if idx.size:
        out[idx] = real
    if virtual:
        virt = np.concatenate([virt, -np.ones((len(virt), 1), np.float32)], axis=1)
        out = np.concatenate([out, virt], axis=0)
    return out.astype(np.float32)


@PIPELINES.register
class LoadMultiViewImageFromFiles:
    def __init__(self, to_float32: bool = False):
        self.to_float32 = to_float32

    def __call__(self, data: Dict[str, Any]):
        imgs = [_imread(p) for p in data["image_paths"]]
        if self.to_float32:
            imgs = [im.astype(np.float32) for im in imgs]
        data["img"] = imgs
        data["ori_shape"] = (imgs[0].shape[1], imgs[0].shape[0])  # (W, H)
        return data


@PIPELINES.register
class LoadPointsFromFile:
    def __init__(self, coord_type="LIDAR", load_dim=5, use_dim=5,
                 reduce_beams=32, load_augmented=None):
        self.load_dim = load_dim
        self.use_dim = list(range(use_dim)) if isinstance(use_dim, int) else use_dim
        self.reduce_beams = reduce_beams
        self.load_augmented = load_augmented

    def __call__(self, data: Dict[str, Any]):
        if self.load_augmented:
            assert self.load_augmented in ("pointpainting", "mvp")
            pts = load_augmented_point_cloud(
                data["lidar_path"], virtual=self.load_augmented == "mvp",
                reduce_beams=self.reduce_beams or 32)
        else:
            pts = _load_points_bin(data["lidar_path"], self.load_dim)
        if self.reduce_beams and self.reduce_beams < 32:
            pts = reduce_lidar_beams(pts, self.reduce_beams)
        pts = pts[:, self.use_dim]
        data["points"] = LiDARPoints(pts, pts.shape[1])
        return data


@PIPELINES.register
class LoadPointsFromMultiSweeps:
    """Aggregate past sweeps into the keyframe cloud with a time-lag
    feature (loading.py:87+): sweep points are transformed into the
    keyframe lidar frame via sensor2lidar_{rotation,translation}, close
    points (|x|,|y| < 1 m) removed, padding with the keyframe when no
    sweeps exist."""

    def __init__(self, sweeps_num=10, load_dim=5, use_dim=(0, 1, 2, 4),
                 reduce_beams=32, pad_empty_sweeps=False, remove_close=False,
                 test_mode=False, load_augmented=None):
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = list(range(use_dim)) if isinstance(use_dim, int) else list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.test_mode = test_mode
        self.reduce_beams = reduce_beams
        self.load_augmented = load_augmented

    @staticmethod
    def _remove_close(pts: np.ndarray, radius: float = 1.0) -> np.ndarray:
        keep = ~((np.abs(pts[:, 0]) < radius) & (np.abs(pts[:, 1]) < radius))
        return pts[keep]

    def __call__(self, data: Dict[str, Any]):
        points = data["points"].tensor
        # time-lag channel: keyframe = 0
        if points.shape[1] >= 5:
            points = points.copy()
            points[:, 4] = 0.0
        ts = data["timestamp"] / 1e6
        sweeps = data.get("sweeps", [])
        clouds = [points]
        if self.pad_empty_sweeps and len(sweeps) == 0:
            base = self._remove_close(points) if self.remove_close else points
            for _ in range(self.sweeps_num):
                clouds.append(base)
        else:
            rng = data.get("_rng")
            if len(sweeps) <= self.sweeps_num:
                choices = np.arange(len(sweeps))
            elif self.test_mode or rng is None:
                choices = np.arange(self.sweeps_num)
            else:
                choices = rng.choice(len(sweeps), self.sweeps_num, replace=False)
            for i in choices:
                sweep = sweeps[i]
                if self.load_augmented:
                    pts = load_augmented_point_cloud(
                        sweep["data_path"],
                        virtual=self.load_augmented == "mvp",
                        reduce_beams=self.reduce_beams or 32)
                else:
                    pts = _load_points_bin(sweep["data_path"], self.load_dim)
                if self.reduce_beams and self.reduce_beams < 32:
                    pts = reduce_lidar_beams(pts, self.reduce_beams)
                pts = pts[:, self.use_dim] if len(self.use_dim) != pts.shape[1] else pts
                if self.remove_close:
                    pts = self._remove_close(pts)
                pts = _transform_sweep_points(
                    pts,
                    np.asarray(sweep["sensor2lidar_rotation"], np.float32),
                    np.asarray(sweep["sensor2lidar_translation"], np.float32),
                    float(ts - sweep["timestamp"] / 1e6),
                )
                clouds.append(pts)
        data["points"] = LiDARPoints(np.concatenate(clouds, 0), points.shape[1])
        return data


@PIPELINES.register
class LoadAnnotations3D:
    def __init__(self, with_bbox_3d=True, with_label_3d=True, with_attr_label=False):
        self.with_bbox_3d = with_bbox_3d
        self.with_label_3d = with_label_3d

    def __call__(self, data: Dict[str, Any]):
        ann = data.get("ann_info", {})
        if self.with_bbox_3d:
            boxes = np.asarray(ann.get("gt_bboxes_3d", np.zeros((0, 9))), np.float32)
            if boxes.size and boxes.shape[1] < 9:
                boxes = np.pad(boxes, ((0, 0), (0, 9 - boxes.shape[1])))
            data["gt_bboxes_3d"] = LiDARBoxes3D(boxes, 9)
        if self.with_label_3d:
            data["gt_labels_3d"] = np.asarray(
                ann.get("gt_labels_3d", np.zeros((0,), np.int64))
            )
        return data


@PIPELINES.register
class LoadBEVSegmentation:
    """Rasterize nuScenes map layers into BEV GT masks (loading.py:244-313):
    patch pose = lidar->global with the lidar aug inverted, 6 classes
    with 'divider' = road_divider | lane_divider. Requires the nuScenes
    map expansion; gated import."""

    def __init__(self, dataset_root, xbound, ybound, classes):
        self.dataset_root = dataset_root
        self.xbound = xbound
        self.ybound = ybound
        self.classes = list(classes)
        patch_h = ybound[1] - ybound[0]
        patch_w = xbound[1] - xbound[0]
        self.patch_size = (patch_h, patch_w)
        canvas_h = int(patch_h / ybound[2])
        canvas_w = int(patch_w / xbound[2])
        self.canvas_size = (canvas_h, canvas_w)
        self._maps = {}

    _MAPPINGS = {
        "drivable_area": ["road_segment", "lane"],
        "divider": ["road_divider", "lane_divider"],
        "ped_crossing": ["ped_crossing"],
        "walkway": ["walkway"],
        "stop_line": ["stop_line"],
        "carpark_area": ["carpark_area"],
    }

    def _get_map(self, location):
        if location not in self._maps:
            from nuscenes.map_expansion.map_api import NuScenesMap

            self._maps[location] = NuScenesMap(self.dataset_root, location)
        return self._maps[location]

    def __call__(self, data: Dict[str, Any]):
        if "location" not in data:
            # no map available (e.g. synthetic data): emit empty masks
            data["gt_masks_bev"] = np.zeros(
                (len(self.classes),) + self.canvas_size, np.float32
            )
            return data
        lidar2global = (
            data["ego2global"] @ data["lidar2ego"]
            @ np.linalg.inv(data.get("lidar_aug_matrix", np.eye(4)))
        )
        x, y = lidar2global[0, 3], lidar2global[1, 3]
        v = lidar2global[:3, 0]
        yaw = np.arctan2(v[1], v[0])
        patch_box = (x, y, self.patch_size[0], self.patch_size[1])
        patch_angle = yaw / np.pi * 180

        layers = []
        for name in self.classes:
            layers.extend(self._MAPPINGS.get(name, [name]))
        layers = sorted(set(layers))
        nmap = self._get_map(data["location"])
        masks = nmap.get_map_mask(patch_box, patch_angle, layers, self.canvas_size)
        masks = masks.transpose(0, 2, 1).astype(np.bool_)

        num_classes = len(self.classes)
        out = np.zeros((num_classes,) + self.canvas_size, np.float32)
        for k, name in enumerate(self.classes):
            for layer in self._MAPPINGS.get(name, [name]):
                idx = layers.index(layer)
                out[k] = np.maximum(out[k], masks[idx].astype(np.float32))
        data["gt_masks_bev"] = out
        return data


def reduce_lidar_beams(pts: np.ndarray, reduce_beams_to: int = 32) -> np.ndarray:
    """Subsample the 32-beam nuScenes lidar to 16/4/1 beams by elevation
    band (loading_utils.py:58+)."""
    if reduce_beams_to >= 32:
        return pts
    radius = np.sqrt((pts[:, :3] ** 2).sum(-1))
    theta = np.arcsin(np.clip(pts[:, 2] / np.maximum(radius, 1e-9), -1, 1))
    beam_range = np.zeros(32, np.float32)
    beam_range[0] = 0.1862
    for i in range(1, 32):
        beam_range[i] = beam_range[i - 1] - 0.023275
    beam_range[31] = -0.5353
    ids = {16: range(1, 32, 2), 4: [7, 9, 11, 13], 1: [9]}[reduce_beams_to]
    mask = np.zeros(len(pts), bool)
    for bid in ids:
        mask |= (theta < (beam_range[bid - 1] - 0.012)) & (
            theta > (beam_range[bid] - 0.012))
    return pts[mask]


@PIPELINES.register
class LoadRadarPointsMultiSweeps:
    """Load + aggregate nuScenes radar sweeps (loading.py:576-793):
    per-radar sweeps are transformed into the keyframe lidar frame,
    velocities rotated (and optionally used to compensate point motion
    over the time lag), dynprop/ambig/invalid states one-hot/ordinal
    encoded, then padded/dropped to ``max_num`` points."""

    def __init__(self, load_dim=18, use_dim=(0, 1, 2, 3, 4), sweeps_num=3,
                 max_num=300, pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                 compensate_velocity=False,
                 normalize_dims=((3, 0, 50), (4, -100, 100), (5, -100, 100)),
                 filtering="default", normalize=False, test_mode=False):
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.sweeps_num = sweeps_num
        self.max_num = max_num
        self.compensate_velocity = compensate_velocity
        self.normalize_dims = normalize_dims
        self.filtering = filtering
        self.normalize = normalize

    _ENCODINGS = (
        (3, "one-hot", 8),    # dynprop
        (11, "one-hot", 5),   # ambig_state
        (14, "one-hot", 18),  # invalid_state
        (15, "ordinal", 7),   # pdh
        (0, "nusc-filter", 1),
    )

    def _load(self, path):
        from nuscenes.utils.data_classes import RadarPointCloud

        inv, dyn, amb = {
            "default": ([0], range(7), [3]),
            "none": (range(18), range(8), range(5)),
        }[self.filtering]
        rpc = RadarPointCloud.from_file(path, inv, dyn, amb)
        return rpc.points.T.astype(np.float32)

    def _encode(self, points):
        for idx, etype, dims in self._ENCODINGS:
            feat = points[:, idx]
            enc = np.zeros((points.shape[0], dims), np.float32)
            if etype == "one-hot":
                enc[np.arange(len(feat)), np.clip(np.rint(feat).astype(int), 0, dims - 1)] = 1
            elif etype == "ordinal":
                for i in range(dims):
                    enc[:, i] = (np.rint(feat) > i).astype(np.float32)
            else:  # nusc-filter
                m = (points[:, 14] == 0) & (points[:, 3] < 7) & (points[:, 11] == 3)
                enc[m, 0] = 1
            points = np.concatenate([points, enc], axis=1)
        return points

    def __call__(self, data):
        sweeps_per_radar = data["radar"]
        clouds = []
        for _, sweeps in sweeps_per_radar.items():
            n = min(len(sweeps), self.sweeps_num)
            ts = sweeps[0]["timestamp"] * 1e-6
            for idx in range(n):
                sweep = sweeps[idx]
                pts = self._load(sweep["data_path"]).reshape(-1, self.load_dim)
                dt = np.full((len(pts), 1), ts - sweep["timestamp"] * 1e-6, np.float32)
                R = np.asarray(sweep["sensor2lidar_rotation"], np.float32)
                t = np.asarray(sweep["sensor2lidar_translation"], np.float32)

                def rot2(v):
                    v3 = np.concatenate([v, np.zeros((len(v), 1), np.float32)], 1)
                    return (v3 @ R.T)[:, :2]

                velo = rot2(pts[:, 6:8])
                velo_comp = rot2(pts[:, 8:10])
                pts[:, :3] = pts[:, :3] @ R.T + t
                if self.compensate_velocity:
                    pts[:, :2] += velo_comp * dt
                clouds.append(np.concatenate(
                    [pts[:, :6], velo, velo_comp, pts[:, 10:], dt], axis=1))
        points = np.concatenate(clouds, axis=0)
        points = self._encode(points)[:, self.use_dim]
        if self.normalize:
            for dim, lo, hi in self.normalize_dims:
                points[:, dim] = (points[:, dim] - lo) / (hi - lo)
        # pad/drop to max_num (loading.py:680-709)
        n = len(points)
        out = np.zeros((self.max_num, points.shape[1]), np.float32)
        m = np.zeros((self.max_num,), bool)
        k = min(n, self.max_num)
        if n > self.max_num:
            sel = np.random.permutation(n)[: self.max_num]
            out[:] = points[sel]
            m[:] = True
        else:
            out[:k] = points[:k]
            m[:k] = True
        data["radar"] = out
        data["radar_mask"] = m
        return data
