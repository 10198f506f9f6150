"""3D anchor generators (numpy, host-side).

A copy of ``bevfusion_tpu/core/anchors.py``, held to it bit for bit by
tests/test_torch_core_inventory.py; the generators register in the port's
``ANCHOR_GENERATORS`` under the JAX names.

Behavioral reference: mmdet3d/core/anchor/anchor_3d_generator.py —
Anchor3DRangeGenerator (:7): anchors on a regular grid over `ranges`
with per-class `sizes` and `rotations`; the aligned variant (:223)
shifts centers by half a voxel; per-class ranges variant (:338).
Present in the reference but unused by BEVFusion configs; provided for
anchor-based heads (SECOND/PointPillars-style) built on this framework.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..registry import Registry

ANCHOR_GENERATORS = Registry("anchor_generators")

__all__ = ["Anchor3DRangeGenerator", "AlignedAnchor3DRangeGenerator",
           "ANCHOR_GENERATORS"]


@ANCHOR_GENERATORS.register
class Anchor3DRangeGenerator:
    def __init__(self, ranges, sizes=((1.6, 3.9, 1.56),),
                 rotations=(0.0, 1.5707963), scales=(1,),
                 custom_values=(), size_per_range=True, align_corner=False):
        self.ranges = [list(r) for r in ranges]
        self.sizes = [list(s) for s in sizes]
        self.rotations = list(rotations)
        self.scales = list(scales)
        self.custom_values = list(custom_values)
        self.size_per_range = size_per_range
        self.align_corner = align_corner
        if self.size_per_range and len(self.ranges) == 1:
            self.ranges = self.ranges * len(self.sizes)

    @property
    def num_base_anchors(self) -> int:
        return len(self.sizes) * len(self.rotations) * len(self.scales)

    def single_range_anchors(self, feature_size, anchor_range, size, scale):
        """feature_size (nz, ny, nx) -> anchors
        [nz, ny, nx, len(rot), box_dim]."""
        nz, ny, nx = feature_size
        r = np.asarray(anchor_range, np.float32)
        if self.align_corner:
            zc = np.linspace(r[2], r[5], nz, dtype=np.float32)
            yc = np.linspace(r[1], r[4], ny, dtype=np.float32)
            xc = np.linspace(r[0], r[3], nx, dtype=np.float32)
        else:
            zc = np.linspace(r[2], r[5], nz + 1, dtype=np.float32)[:nz]
            yc = np.linspace(r[1], r[4], ny + 1, dtype=np.float32)[:ny]
            xc = np.linspace(r[0], r[3], nx + 1, dtype=np.float32)[:nx]
        zz, yy, xx = np.meshgrid(zc, yc, xc, indexing="ij")
        centers = np.stack([xx, yy, zz], -1)  # [nz, ny, nx, 3]
        dims = np.asarray(size, np.float32) * scale
        out = []
        for rot in self.rotations:
            a = np.concatenate([
                centers,
                np.broadcast_to(dims, centers.shape[:-1] + (3,)),
                np.full(centers.shape[:-1] + (1,), rot, np.float32),
            ], -1)
            if self.custom_values:
                cv = np.broadcast_to(
                    np.asarray(self.custom_values, np.float32),
                    centers.shape[:-1] + (len(self.custom_values),),
                )
                a = np.concatenate([a, cv], -1)
            out.append(a)
        return np.stack(out, axis=3)  # [nz, ny, nx, nrot, box_dim]

    def grid_anchors(self, feature_size) -> np.ndarray:
        """-> [nz, ny, nx, num_base_anchors, box_dim]."""
        per = []
        for scale in self.scales:
            for rng_, size in zip(self.ranges, self.sizes):
                per.append(self.single_range_anchors(feature_size, rng_, size, scale))
        return np.concatenate(per, axis=3)


@ANCHOR_GENERATORS.register
class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    def __init__(self, **kwargs):
        super().__init__(align_corner=False, **kwargs)

    def single_range_anchors(self, feature_size, anchor_range, size, scale):
        """Centers shifted by half a cell (anchor_3d_generator.py:223+)."""
        nz, ny, nx = feature_size
        r = np.asarray(anchor_range, np.float32)
        dz = (r[5] - r[2]) / nz
        dy = (r[4] - r[1]) / ny
        dx = (r[3] - r[0]) / nx
        zc = r[2] + dz / 2 + dz * np.arange(nz, dtype=np.float32)
        yc = r[1] + dy / 2 + dy * np.arange(ny, dtype=np.float32)
        xc = r[0] + dx / 2 + dx * np.arange(nx, dtype=np.float32)
        zz, yy, xx = np.meshgrid(zc, yc, xc, indexing="ij")
        centers = np.stack([xx, yy, zz], -1)
        dims = np.asarray(size, np.float32) * scale
        out = []
        for rot in self.rotations:
            a = np.concatenate([
                centers,
                np.broadcast_to(dims, centers.shape[:-1] + (3,)),
                np.full(centers.shape[:-1] + (1,), rot, np.float32),
            ], -1)
            if self.custom_values:
                cv = np.broadcast_to(
                    np.asarray(self.custom_values, np.float32),
                    centers.shape[:-1] + (len(self.custom_values),),
                )
                a = np.concatenate([a, cv], -1)
            out.append(a)
        return np.stack(out, axis=3)
