"""BEV grid constants shared by the view transform and the pooling LUT.

A copy of ``bevfusion_tpu/ops/grid.py`` (pure numpy; reference
mmdet3d/models/vtransforms/base.py:15-21 and :66-89), kept in the port
because a program that runs the port imports nothing of the JAX package.
``tests/test_torch_camera_ops.py`` holds the copy equal to the original.
"""
from __future__ import annotations

import numpy as np

__all__ = ["gen_dx_bx", "create_frustum"]


def gen_dx_bx(xbound, ybound, zbound):
    """Cell size dx, first-cell center bx, grid dims nx per axis; nx uses
    the truncating float division then an int cast, like the reference."""
    bounds = [xbound, ybound, zbound]
    dx = np.array([row[2] for row in bounds], dtype=np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in bounds], dtype=np.float32)
    nx = np.array([int((row[1] - row[0]) / row[2]) for row in bounds], dtype=np.int64)
    return dx, bx, nx


def create_frustum(image_size, feature_size, dbound):
    """Frustum of (u, v, depth) points at feature resolution, [D, fH, fW, 3]:
    u/v are linspaces over [0, iW-1] / [0, iH-1], depths ``arange(*dbound)``."""
    iH, iW = image_size
    fH, fW = feature_size
    ds = np.arange(dbound[0], dbound[1], dbound[2], dtype=np.float32)
    D = ds.shape[0]
    ds = np.broadcast_to(ds[:, None, None], (D, fH, fW))
    xs = np.broadcast_to(np.linspace(0, iW - 1, fW, dtype=np.float32)[None, None, :], (D, fH, fW))
    ys = np.broadcast_to(np.linspace(0, iH - 1, fH, dtype=np.float32)[None, :, None], (D, fH, fW))
    return np.stack([xs, ys, ds], axis=-1)
