"""Host-side pipeline transforms (numpy).

Copies of ``bevfusion_tpu/data/transforms.py`` (reference
mmdet3d/datasets/pipelines/transforms_3d.py), held to the originals by
tests/test_torch_gtdepth.py. So far ``GTDepth`` (:26-95), the depth
target of BEVDepth's depth loss.
"""
from __future__ import annotations

import numpy as np

__all__ = ["GTDepth"]


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
