"""Host-side pipeline transforms (numpy).

A copy of ``bevfusion_tpu/data/transforms.py``, held to it by
tests/test_torch_data.py (``GTDepth`` by tests/test_torch_gtdepth.py).
Behavioral reference: mmdet3d/datasets/pipelines/transforms_3d.py —
ImageAug3D (:98-193, accumulates the per-camera 4x4 img_aug_matrix),
GlobalRotScaleTrans (:196-233, accumulates lidar_aug_matrix),
RandomFlip3D (:324-355), GridMask (:236-322), range/name filters
(:535-630), PointShuffle (:528), ImageNormalize (:992), GTDepth
(:26-95).

PadBatch pads points and GT boxes to static capacities and emits plain
numpy arrays + masks, so every batch has the same shapes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.box_np import LiDARBoxes3D, points_in_rbbox, rotation_2d
from ..registry import PIPELINES
from .points import LiDARPoints

__all__ = [
    "ImageAug3D", "GlobalRotScaleTrans", "RandomFlip3D", "PointsRangeFilter",
    "ObjectRangeFilter", "ObjectNameFilter", "PointShuffle", "ImageNormalize",
    "GridMask", "GTDepth", "PadBatch", "Collect3D",
]


def _bilinear_resize_hwc(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    H, W = img.shape[:2]
    Ho, Wo = out_hw
    ys = (np.arange(Ho) + 0.5) * H / Ho - 0.5
    xs = (np.arange(Wo) + 0.5) * W / Wo - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(img.dtype)


def _rotate_image_hwc(img: np.ndarray, deg: float) -> np.ndarray:
    """Rotate around center by deg (counterclockwise, PIL convention),
    nearest neighbor, zero fill."""
    if abs(deg) < 1e-9:
        return img
    H, W = img.shape[:2]
    theta = np.deg2rad(deg)
    c, s = np.cos(theta), np.sin(theta)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # inverse map: output (x, y) <- input rotated by -deg
    dx, dy = xx - cx, yy - cy
    sx = np.round(cx + c * dx - s * dy).astype(int)
    sy = np.round(cy + s * dx + c * dy).astype(int)
    ok = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    out = np.zeros_like(img)
    out[yy[ok], xx[ok]] = img[sy[ok], sx[ok]]
    return out


@PIPELINES.register
class ImageAug3D:
    """Resize/crop/flip/rotate each camera image, accumulating the 4x4
    img_aug_matrix used to invert the augmentation in the view
    transform (transforms_3d.py:98-193)."""

    def __init__(self, final_dim, resize_lim, bot_pct_lim, rot_lim,
                 rand_flip, is_train):
        self.final_dim = tuple(final_dim)
        self.resize_lim = resize_lim
        self.bot_pct_lim = bot_pct_lim
        self.rot_lim = rot_lim
        self.rand_flip = rand_flip
        self.is_train = is_train

    def sample(self, W, H, rng):
        fH, fW = self.final_dim
        if self.is_train:
            resize = rng.uniform(*self.resize_lim)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - rng.uniform(*self.bot_pct_lim)) * newH) - fH
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
            flip = bool(self.rand_flip and rng.randint(2))
            rotate = rng.uniform(*self.rot_lim)
        else:
            resize = float(np.mean(self.resize_lim))
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            flip, rotate = False, 0.0
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        return resize, (newW, newH), crop, flip, rotate

    def apply_one(self, img, rng):
        H, W = img.shape[:2]
        fH, fW = self.final_dim
        resize, (newW, newH), crop, flip, rotate = self.sample(W, H, rng)

        img = _bilinear_resize_hwc(img, (newH, newW))
        # crop (x0, y0, x1, y1) with zero pad if out of range
        x0, y0, x1, y1 = crop
        out = np.zeros((fH, fW) + img.shape[2:], img.dtype)
        sy0, sy1 = max(y0, 0), min(y1, newH)
        sx0, sx1 = max(x0, 0), min(x1, newW)
        if sy1 > sy0 and sx1 > sx0:
            out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
        img = out
        if flip:
            img = img[:, ::-1].copy()
        img = _rotate_image_hwc(img, rotate)

        # accumulate the 2D homography exactly like the reference
        rot = np.eye(2, dtype=np.float32) * resize
        tr = -np.asarray(crop[:2], np.float32)
        if flip:
            A = np.array([[-1, 0], [0, 1]], np.float32)
            b = np.array([crop[2] - crop[0], 0], np.float32)
            rot = A @ rot
            tr = A @ tr + b
        theta = rotate / 180 * np.pi
        A = np.array([[np.cos(theta), np.sin(theta)],
                      [-np.sin(theta), np.cos(theta)]], np.float32)
        b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2
        b = A @ (-b) + b
        rot = A @ rot
        tr = A @ tr + b

        m = np.eye(4, dtype=np.float32)
        m[:2, :2] = rot
        m[:2, 3] = tr
        return img, m

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        rng = data.setdefault("_rng", np.random.RandomState())
        imgs, mats = [], []
        for img in data["img"]:
            im, m = self.apply_one(np.asarray(img), rng)
            imgs.append(im)
            mats.append(m)
        data["img"] = imgs
        data["img_aug_matrix"] = np.stack(mats)
        return data


@PIPELINES.register
class GlobalRotScaleTrans:
    """Lidar-frame rotate/scale/translate aug; accumulates
    lidar_aug_matrix with x' = (scale * R) x + scale * t
    (transforms_3d.py:196-233)."""

    def __init__(self, resize_lim, rot_lim, trans_lim, is_train):
        self.resize_lim = resize_lim
        self.rot_lim = rot_lim
        self.trans_lim = trans_lim
        self.is_train = is_train

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        transform = np.eye(4, dtype=np.float32)
        if self.is_train:
            rng = data.setdefault("_rng", np.random.RandomState())
            scale = rng.uniform(*self.resize_lim)
            theta = rng.uniform(*self.rot_lim)
            translation = np.array(
                [rng.normal(0, self.trans_lim) for _ in range(3)], np.float32
            ) if self.trans_lim > 0 else np.zeros(3, np.float32)

            rot = rotation_2d(theta)
            if "points" in data:
                data["points"].rotate(theta)
                data["points"].translate(translation)
                data["points"].scale(scale)
            if "gt_bboxes_3d" in data:
                data["gt_bboxes_3d"].rotate(theta)
                data["gt_bboxes_3d"].translate(translation)
                data["gt_bboxes_3d"].scale(scale)

            transform[:2, :2] = rot * scale
            transform[:3, 3] = translation * scale
            transform[2, 2] = scale
        data["lidar_aug_matrix"] = transform
        return data


@PIPELINES.register
class RandomFlip3D:
    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        rng = data.setdefault("_rng", np.random.RandomState())
        flip_h = bool(rng.randint(2))
        flip_v = bool(rng.randint(2))
        rotation = np.eye(3, dtype=np.float32)
        if flip_h:
            rotation = np.diag([1.0, -1.0, 1.0]).astype(np.float32) @ rotation
            if "points" in data:
                data["points"].flip("horizontal")
            if "gt_bboxes_3d" in data:
                data["gt_bboxes_3d"].flip("horizontal")
            if "gt_masks_bev" in data:
                data["gt_masks_bev"] = data["gt_masks_bev"][:, :, ::-1].copy()
        if flip_v:
            rotation = np.diag([-1.0, 1.0, 1.0]).astype(np.float32) @ rotation
            if "points" in data:
                data["points"].flip("vertical")
            if "gt_bboxes_3d" in data:
                data["gt_bboxes_3d"].flip("vertical")
            if "gt_masks_bev" in data:
                data["gt_masks_bev"] = data["gt_masks_bev"][:, ::-1, :].copy()
        if "lidar_aug_matrix" not in data:
            data["lidar_aug_matrix"] = np.eye(4, dtype=np.float32)
        data["lidar_aug_matrix"][:3, :] = rotation @ data["lidar_aug_matrix"][:3, :]
        return data


@PIPELINES.register
class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, data):
        data["points"] = data["points"][data["points"].in_range_3d(self.pcr)]
        return data


@PIPELINES.register
class ObjectRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, data):
        boxes: LiDARBoxes3D = data["gt_bboxes_3d"]
        mask = boxes.in_range_bev(self.pcr)
        boxes.tensor = boxes.tensor[mask]
        boxes.limit_yaw(offset=0.5, period=2 * np.pi)
        data["gt_labels_3d"] = np.asarray(data["gt_labels_3d"])[mask]
        return data


@PIPELINES.register
class ObjectNameFilter:
    def __init__(self, classes):
        self.labels = list(range(len(classes)))

    def __call__(self, data):
        labels = np.asarray(data["gt_labels_3d"])
        mask = np.isin(labels, self.labels)
        data["gt_bboxes_3d"].tensor = data["gt_bboxes_3d"].tensor[mask]
        data["gt_labels_3d"] = labels[mask]
        return data


@PIPELINES.register
class PointShuffle:
    def __call__(self, data):
        rng = data.setdefault("_rng", np.random.RandomState())
        data["points"].shuffle(rng)
        return data


@PIPELINES.register
class ImageNormalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, data):
        data["img"] = [
            ((np.asarray(im, np.float32) / 255.0) - self.mean) / self.std
            for im in data["img"]
        ]
        return data


@PIPELINES.register
class GridMask:
    """Structured dropout over images (transforms_3d.py:236-322): zero a
    grid of square patches with probability ``prob`` (optionally ramped
    by epoch)."""

    def __init__(self, use_h, use_w, max_epoch, rotate=1, offset=False,
                 ratio=0.5, mode=1, prob=1.0, fixed_prob=False):
        self.use_h, self.use_w = use_h, use_w
        self.rotate = rotate
        self.offset = offset
        self.ratio = ratio
        self.mode = mode
        self.st_prob = self.prob = prob
        self.max_epoch = max_epoch
        self.fixed_prob = fixed_prob
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        if not self.fixed_prob:
            self.prob = self.st_prob * self.epoch / self.max_epoch

    def __call__(self, data):
        rng = data.setdefault("_rng", np.random.RandomState())
        if rng.rand() > self.prob:
            return data
        imgs = [np.asarray(im) for im in data["img"]]
        H, W = imgs[0].shape[:2]
        d = rng.randint(2, max(3, min(H, W)))
        ll = min(max(int(d * self.ratio + 0.5), 1), d - 1)
        mask = np.ones((H * 2, W * 2), np.float32)
        st_h, st_w = rng.randint(d), rng.randint(d)
        if self.use_h:
            for i in range(-1, H * 2 // d + 1):
                s = max(d * i + st_h, 0)
                mask[s:s + ll, :] = 0
        if self.use_w:
            for i in range(-1, W * 2 // d + 1):
                s = max(d * i + st_w, 0)
                mask[:, s:s + ll] = 0
        mask = mask[H // 2:H // 2 + H, W // 2:W // 2 + W]
        if self.mode == 1:
            mask = 1 - mask
        data["img"] = [im * mask[..., None] for im in imgs]
        return data


@PIPELINES.register
class GTDepth:
    """Project (keyframe) LiDAR points into each camera: ``data["depths"]``
    [N, H, W] float32, the camera-frame depth of the point that lands in a
    pixel (the last one written where several do), 0 where none does.

    ``data`` holds ``points`` ([P, >= 3] numpy, or an object with a
    ``.tensor`` array such as ``LiDARPoints``; column 4 the sweep's time
    lag, 0 for the keyframe), ``lidar2image`` [N, 4, 4], ``img_aug_matrix``
    [N, 4, 4], ``lidar_aug_matrix`` [4, 4] and ``img``, the N images (H, W,
    ...) that fix the size. With ``keyframe_only`` and a fifth column, only
    the keyframe's points project."""

    def __init__(self, keyframe_only=False):
        self.keyframe_only = keyframe_only

    def __call__(self, data):
        pts = getattr(data["points"], "tensor", data["points"])
        if self.keyframe_only and pts.shape[1] > 4:
            pts = pts[pts[:, 4] == 0]
        l2i = np.asarray(data["lidar2image"], np.float32)
        ia = np.asarray(data["img_aug_matrix"], np.float32)
        la = np.asarray(data["lidar_aug_matrix"], np.float32)
        imgs = data["img"]
        N = len(imgs)
        H, W = np.asarray(imgs[0]).shape[:2]

        xyz = pts[:, :3] - la[:3, 3]
        xyz = xyz @ np.linalg.inv(la[:3, :3]).T
        cam = np.einsum("nij,pj->npi", l2i[:, :3, :3], xyz) + l2i[:, None, :3, 3]
        dist = cam[..., 2]
        z = np.clip(cam[..., 2], 1e-5, 1e5)
        uv1 = np.concatenate([cam[..., :2] / z[..., None], np.ones_like(z)[..., None]], -1)
        uv = np.einsum("nij,npj->npi", ia[:, :3, :3], uv1) + ia[:, None, :3, 3]
        r, c = uv[..., 1], uv[..., 0]
        depth = np.zeros((N, H, W), np.float32)
        for n in range(N):
            ok = (r[n] >= 0) & (r[n] < H) & (c[n] >= 0) & (c[n] < W) & (dist[n] > 0)
            depth[n, r[n, ok].astype(int), c[n, ok].astype(int)] = dist[n, ok]
        data["depths"] = depth
        return data


@PIPELINES.register
class PadBatch:
    """Pad points / GT boxes to fixed capacities with validity masks, so
    every sample has the same shapes."""

    def __init__(self, max_points: int, max_gt_boxes: int):
        self.max_points = max_points
        self.max_gt = max_gt_boxes

    def __call__(self, data):
        pts = data["points"].tensor
        P = self.max_points
        n = min(len(pts), P)
        out = np.zeros((P, pts.shape[1]), np.float32)
        out[:n] = pts[:n]
        mask = np.zeros((P,), bool)
        mask[:n] = True
        data["points"] = out
        data["points_mask"] = mask

        if "gt_bboxes_3d" in data:
            boxes = data["gt_bboxes_3d"].tensor
            G = self.max_gt
            g = min(len(boxes), G)
            bb = np.zeros((G, boxes.shape[1] if boxes.size else 9), np.float32)
            if g:
                bb[:g] = boxes[:g]
            lb = np.zeros((G,), np.int32)
            if g:
                lb[:g] = np.asarray(data["gt_labels_3d"])[:g]
            gm = np.zeros((G,), bool)
            gm[:g] = True
            data["gt_boxes"] = bb
            data["gt_labels"] = lb
            data["gt_valid"] = gm
        return data


@PIPELINES.register
class Collect3D:
    """Assemble the final numpy sample dict (pipelines/formating.py:131)."""

    def __init__(self, keys, meta_keys=()):
        self.keys = tuple(keys)
        self.meta_keys = tuple(meta_keys)

    def __call__(self, data):
        out = {}
        if "img" in self.keys and "img" in data:
            out["img"] = np.stack([np.asarray(im, np.float32) for im in data["img"]])
        for k in ("points", "points_mask", "gt_boxes", "gt_labels", "gt_valid",
                  "gt_masks_bev", "depths"):
            if k in data:
                out[k] = np.asarray(data[k])
        for k in self.meta_keys:
            if k in data:
                out[k] = np.asarray(data[k], np.float32)
        if "metas" in data:
            out["metas"] = data["metas"]
        return out
