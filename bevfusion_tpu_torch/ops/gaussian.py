"""Gaussian heatmap targets.

Counterpart of ``bevfusion_tpu/ops/gaussian.py`` (reference
mmdet3d/core/utils/gaussian.py:24-84): each object's gaussian is
evaluated over the whole map and the objects of one class combine by
maximum, the same result as the reference's pasted patches.
"""
from __future__ import annotations

import torch

__all__ = ["gaussian_radius", "draw_heatmap_gaussians"]


def gaussian_radius(det_size, min_overlap: float = 0.5) -> torch.Tensor:
    """Radius such that a shifted box keeps IoU >= min_overlap: the least
    of the three quadratic roots. det_size = (length, width) in feature-map
    units (tensors)."""
    height, width = det_size

    def root(a, b, c):
        return (b + torch.sqrt(torch.clamp(b ** 2 - 4 * a * c, min=0.0))) / 2

    r1 = root(1.0, height + width, width * height * (1 - min_overlap) / (1 + min_overlap))
    r2 = root(4.0, 2 * (height + width), (1 - min_overlap) * width * height)
    r3 = root(4.0 * min_overlap, -2 * min_overlap * (height + width),
              (min_overlap - 1) * width * height)
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_heatmap_gaussians(heatmap: torch.Tensor, centers_int: torch.Tensor,
                           radii: torch.Tensor, cls_ids: torch.Tensor,
                           valid: torch.Tensor, k: float = 1.0) -> torch.Tensor:
    """Max-combine one gaussian per object into per-class heatmaps.

    heatmap [num_classes, H, W]; centers_int [N, 2] (x, y) int; radii [N]
    int; cls_ids [N] int; valid [N] bool. The gaussian of an object is
    exp(-(dx^2 + dy^2) / (2 sigma^2)) with sigma = (2r + 1) / 6 on integer
    offsets from its center, zeroed below float64 eps and outside the
    (2r + 1)^2 square."""
    num_classes, H, W = heatmap.shape
    dev = heatmap.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    dx = xs - centers_int[:, 0].float()[:, None, None]
    dy = ys - centers_int[:, 1].float()[:, None, None]
    sigma = (2 * radii + 1).float()[:, None, None] / 6.0
    g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    g = torch.where(g < 2.220446049250313e-16, 0.0, g)
    r = radii.float()[:, None, None]
    g = torch.where((dx.abs() <= r) & (dy.abs() <= r) & valid[:, None, None], g * k, 0.0)
    seg = torch.where(valid, cls_ids.long(), num_classes)  # invalid -> dump row
    g = g.reshape(-1, H * W).to(heatmap.dtype)
    per_class = heatmap.new_zeros((num_classes + 1, H * W)).scatter_reduce_(
        0, seg[:, None].expand_as(g), g, "amax")
    return torch.maximum(heatmap, per_class[:num_classes].view(num_classes, H, W))
