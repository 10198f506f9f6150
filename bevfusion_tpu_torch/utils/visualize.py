"""Visualization: camera boxes, BEV lidar, map masks.

A copy of ``bevfusion_tpu/utils/visualize.py`` on the port's
``core/box_np.py``, held to it byte for byte (the PNGs) by
tests/test_torch_visualize.py. Behavioral reference:
mmdet3d/core/utils/visualize.py (visualize_camera:43, visualize_lidar:113,
visualize_map:165) — same class palette and output conventions (PNG per
camera / BEV / map). Host code on numpy arrays; matplotlib is imported at
the first drawing, not at import.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["OBJECT_PALETTE", "MAP_PALETTE", "visualize_camera",
           "visualize_lidar", "visualize_map"]

OBJECT_PALETTE = {
    "car": (255, 158, 0),
    "truck": (255, 99, 71),
    "construction_vehicle": (233, 150, 70),
    "bus": (255, 69, 0),
    "trailer": (255, 140, 0),
    "barrier": (112, 128, 144),
    "motorcycle": (255, 61, 99),
    "bicycle": (220, 20, 60),
    "pedestrian": (0, 0, 230),
    "traffic_cone": (47, 79, 79),
}

MAP_PALETTE = {
    "drivable_area": (166, 206, 227),
    "road_segment": (31, 120, 180),
    "road_block": (178, 223, 138),
    "lane": (51, 160, 44),
    "ped_crossing": (251, 154, 153),
    "walkway": (227, 26, 28),
    "stop_line": (253, 191, 111),
    "carpark_area": (255, 127, 0),
    "road_divider": (202, 178, 214),
    "lane_divider": (106, 61, 154),
    "divider": (106, 61, 154),
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _box_corners3d(boxes: np.ndarray) -> np.ndarray:
    from ..core.box_np import LiDARBoxes3D

    return LiDARBoxes3D(boxes, boxes.shape[-1]).corners()


_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6), (6, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def visualize_camera(path: str, image: np.ndarray, boxes: Optional[np.ndarray],
                     labels: Optional[np.ndarray], lidar2image: np.ndarray,
                     classes: Sequence[str]) -> None:
    plt = _plt()
    fig = plt.figure(figsize=(image.shape[1] / 100, image.shape[0] / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.imshow(image.astype(np.uint8))
    ax.axis("off")
    if boxes is not None and len(boxes):
        corners = _box_corners3d(np.asarray(boxes))
        N = corners.shape[0]
        pts = np.concatenate([corners.reshape(-1, 3),
                              np.ones((N * 8, 1))], -1)
        cam = pts @ np.asarray(lidar2image).T
        z = np.clip(cam[:, 2], 1e-5, None)
        uv = (cam[:, :2] / z[:, None]).reshape(N, 8, 2)
        vis = (cam[:, 2] > 0.1).reshape(N, 8)
        for i in range(N):
            if not vis[i].all():
                continue
            color = np.array(
                OBJECT_PALETTE[classes[int(labels[i])]]
            ) / 255.0 if labels is not None else (1, 0, 0)
            for a, b in _EDGES:
                ax.plot(uv[i, [a, b], 0], uv[i, [a, b], 1],
                        color=color, linewidth=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def visualize_lidar(path: str, points: Optional[np.ndarray],
                    boxes: Optional[np.ndarray] = None,
                    labels: Optional[np.ndarray] = None,
                    classes: Sequence[str] = (),
                    xlim=(-54, 54), ylim=(-54, 54)) -> None:
    plt = _plt()
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect(1)
    ax.axis("off")
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 1], s=0.1, c="white")
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")
    if boxes is not None and len(boxes):
        from ..core.box_np import corners_bev

        cb = corners_bev(np.asarray(boxes)[:, [0, 1, 3, 4, 6]])
        for i in range(len(cb)):
            color = np.array(
                OBJECT_PALETTE[classes[int(labels[i])]]
            ) / 255.0 if labels is not None and len(classes) else (1, 0, 0)
            poly = np.concatenate([cb[i], cb[i][:1]], 0)
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def visualize_map(path: str, masks: np.ndarray, classes: Sequence[str]) -> None:
    """masks [num_classes, H, W] (bool or probs >= 0.5)."""
    canvas = np.zeros((*masks.shape[1:], 3), np.uint8)
    canvas[:] = 240
    for k, name in enumerate(classes):
        if name not in MAP_PALETTE:
            continue
        canvas[masks[k] >= 0.5] = MAP_PALETTE[name]
    canvas = np.flipud(canvas)
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(canvas).save(path)
