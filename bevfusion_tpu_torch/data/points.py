"""Numpy point-cloud container for the host pipeline.

A copy of ``bevfusion_tpu/data/points.py``, held to it by
tests/test_torch_data.py. Behavioral reference:
mmdet3d/core/points/base_points.py (+ LiDARPoints): [P, dim] array (x, y,
z, intensity, time_lag, ...), with rotate / translate / scale / flip /
shuffle / range filters.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.box_np import rotation_2d

__all__ = ["LiDARPoints"]


class LiDARPoints:
    def __init__(self, tensor: np.ndarray, points_dim: int = 5):
        self.tensor = np.asarray(tensor, np.float32).reshape(-1, points_dim)
        self.points_dim = points_dim

    def __len__(self):
        return self.tensor.shape[0]

    def __getitem__(self, item):
        return LiDARPoints(self.tensor[item], self.points_dim)

    @property
    def coord(self) -> np.ndarray:
        return self.tensor[:, :3]

    def rotate(self, angle: float) -> np.ndarray:
        rot = rotation_2d(angle)
        self.tensor[:, :2] = self.tensor[:, :2] @ rot.T
        return rot

    def translate(self, trans) -> None:
        self.tensor[:, :3] += np.asarray(trans, np.float32)

    def scale(self, factor: float) -> None:
        self.tensor[:, :3] *= factor

    def flip(self, direction: str = "horizontal") -> None:
        if direction == "horizontal":
            self.tensor[:, 1] = -self.tensor[:, 1]
        elif direction == "vertical":
            self.tensor[:, 0] = -self.tensor[:, 0]
        else:
            raise ValueError(direction)

    def shuffle(self, rng: np.random.RandomState = None) -> None:
        rng = rng or np.random
        perm = rng.permutation(len(self))
        self.tensor = self.tensor[perm]

    def in_range_3d(self, pcr: Sequence[float]) -> np.ndarray:
        t = self.tensor
        return (
            (t[:, 0] > pcr[0]) & (t[:, 1] > pcr[1]) & (t[:, 2] > pcr[2])
            & (t[:, 0] < pcr[3]) & (t[:, 1] < pcr[4]) & (t[:, 2] < pcr[5])
        )

    def in_range_bev(self, rng4: Sequence[float]) -> np.ndarray:
        t = self.tensor
        return (
            (t[:, 0] > rng4[0]) & (t[:, 1] > rng4[1])
            & (t[:, 0] < rng4[2]) & (t[:, 1] < rng4[3])
        )

    @staticmethod
    def cat(points_list):
        dims = points_list[0].points_dim
        return LiDARPoints(
            np.concatenate([p.tensor for p in points_list], 0), dims
        )

    def copy(self):
        return LiDARPoints(self.tensor.copy(), self.points_dim)
