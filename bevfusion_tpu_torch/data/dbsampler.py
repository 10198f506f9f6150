"""GT-database sampling (ObjectPaste augmentation), host-side numpy.

A copy of ``bevfusion_tpu/data/dbsampler.py``, held to it bit for bit by
tests/test_torch_dbsampler.py. Behavioral reference:
mmdet3d/datasets/pipelines/dbsampler.py:79-323 (per-class sample groups,
collision rejection via BEV-corner box_collision_test from
pipelines/utils.py:31) and the ObjectPaste transform
(transforms_3d.py:357-451): sampled object point crops are pasted into the
scene, original points inside sampled boxes removed. The JAX package tests
the points against the sampled boxes in its C++ host library
(``native.points_in_rbbox``); the port computes the same mask bit for bit
in numpy (``core/box_np.py:points_in_rbbox_libm``).
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from ..core.box_np import LiDARBoxes3D, corners_bev, points_in_rbbox_libm
from ..registry import PIPELINES
from .points import LiDARPoints

__all__ = ["DataBaseSampler", "ObjectPaste"]


def _boxes_overlap_bev(corners1: np.ndarray, corners2: np.ndarray) -> np.ndarray:
    """[N,4,2] x [M,4,2] -> [N,M] bool rotated-rectangle overlap via the
    separating axis theorem (replaces the numba box_collision_test)."""
    N, M = corners1.shape[0], corners2.shape[0]
    if N == 0 or M == 0:
        return np.zeros((N, M), bool)

    def axes(c):
        e = np.stack([c[:, 1] - c[:, 0], c[:, 3] - c[:, 0]], axis=1)  # [*, 2, 2]
        n = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)

    ax = np.concatenate(
        [np.broadcast_to(axes(corners1)[:, None], (N, M, 2, 2)),
         np.broadcast_to(axes(corners2)[None], (N, M, 2, 2))], axis=2
    )  # [N, M, 4, 2]
    p1 = np.einsum("nmax,nkx->nmak", ax, corners1)  # [N,M,4,4]
    p2 = np.einsum("nmax,mkx->nmak", ax, corners2)
    sep = (p1.max(-1) < p2.min(-1)) | (p2.max(-1) < p1.min(-1))
    return ~sep.any(-1)


class DataBaseSampler:
    def __init__(self, dataset_root, info_path, rate, prepare, classes,
                 sample_groups, points_loader=None, type=None):
        self.dataset_root = dataset_root
        self.rate = rate
        self.classes = list(classes)
        self.sample_groups = dict(sample_groups)
        self.points_dim = (points_loader or {}).get("use_dim", 5)
        if isinstance(self.points_dim, (list, tuple)):
            self.points_dim = len(self.points_dim)

        with open(info_path, "rb") as f:
            db_infos = pickle.load(f)
        # prepare filters (dbsampler.py: filter_by_difficulty / min_points)
        min_points = (prepare or {}).get("filter_by_min_points", {})
        for name, infos in list(db_infos.items()):
            thr = int(min_points.get(name, 0))
            db_infos[name] = [i for i in infos if i["num_points_in_gt"] >= thr]
        self.db_infos = db_infos
        self._rng = np.random.RandomState(0)

    def sample_class(self, name: str, num: int, rng) -> List[dict]:
        pool = self.db_infos.get(name, [])
        if not pool or num <= 0:
            return []
        idx = rng.choice(len(pool), num)
        return [pool[i] for i in idx]

    def sample_all(self, gt_boxes: np.ndarray, gt_labels: np.ndarray, rng=None):
        rng = rng or self._rng
        sampled, sampled_boxes, sampled_labels = [], [], []
        avoid = gt_boxes.copy() if gt_boxes.size else np.zeros((0, 9), np.float32)
        for name, max_num in self.sample_groups.items():
            cls_id = self.classes.index(name)
            existing = int((gt_labels == cls_id).sum())
            need = int(self.rate * max(0, int(max_num) - existing))
            cands = self.sample_class(name, need, rng)
            if not cands:
                continue
            cand_boxes = np.stack([np.asarray(c["box3d_lidar"], np.float32) for c in cands])
            if cand_boxes.shape[1] < 9:
                cand_boxes = np.pad(cand_boxes, ((0, 0), (0, 9 - cand_boxes.shape[1])))
            # collision test vs existing + previously accepted
            all_prev = np.concatenate([avoid] + ([np.stack(sampled_boxes)] if sampled_boxes else []), 0)
            c_new = corners_bev(cand_boxes[:, [0, 1, 3, 4, 6]])
            c_prev = corners_bev(all_prev[:, [0, 1, 3, 4, 6]]) if len(all_prev) else np.zeros((0, 4, 2))
            coll_prev = _boxes_overlap_bev(c_new, c_prev).any(-1) if len(all_prev) else np.zeros(len(cands), bool)
            coll_self = _boxes_overlap_bev(c_new, c_new)
            np.fill_diagonal(coll_self, False)
            keep = ~coll_prev
            # greedy self-dedup in order
            for i in range(len(cands)):
                if not keep[i]:
                    continue
                keep &= ~(coll_self[i] & (np.arange(len(cands)) > i)) | ~keep[i]
            for i in np.where(keep)[0]:
                sampled.append(cands[i])
                sampled_boxes.append(cand_boxes[i])
                sampled_labels.append(cls_id)
        if not sampled:
            return None
        # load the per-object point crops
        pts = []
        for info, box in zip(sampled, sampled_boxes):
            path = os.path.join(self.dataset_root, info["path"])
            p = np.fromfile(path, dtype=np.float32).reshape(-1, self.points_dim)
            p = p.copy()
            p[:, :3] += box[:3]  # crops are stored box-centered
            pts.append(p)
        return {
            "gt_bboxes_3d": np.stack(sampled_boxes),
            "gt_labels_3d": np.asarray(sampled_labels, np.int64),
            "points": np.concatenate(pts, 0),
        }


@PIPELINES.register
class ObjectPaste:
    """Paste sampled GT objects into the scene until ``stop_epoch``
    (``set_epoch``; a negative or absent ``stop_epoch`` never stops). The
    pasted crops come first in the point cloud, so ``PadBatch``'s cap cuts
    the scan's tail, as in the JAX package."""

    def __init__(self, db_sampler, sample_2d=False, stop_epoch=None):
        self.sampler = DataBaseSampler(**{k: v for k, v in dict(db_sampler).items()
                                          if k != "type"})
        self.stop_epoch = stop_epoch
        self.epoch = -1

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __call__(self, data):
        if self.stop_epoch is not None and 0 <= self.stop_epoch <= self.epoch:
            return data
        rng = data.get("_rng")
        boxes: LiDARBoxes3D = data["gt_bboxes_3d"]
        labels = np.asarray(data["gt_labels_3d"])
        sampled = self.sampler.sample_all(boxes.tensor, labels, rng)
        if sampled is None:
            return data
        data["gt_labels_3d"] = np.concatenate([labels, sampled["gt_labels_3d"]])
        data["gt_bboxes_3d"] = LiDARBoxes3D(
            np.concatenate([boxes.tensor, sampled["gt_bboxes_3d"]]), boxes.box_dim
        )
        pts: LiDARPoints = data["points"]
        inside = points_in_rbbox_libm(pts.coord, sampled["gt_bboxes_3d"][:, :7])
        pts = pts[~inside.any(-1)]
        spts = sampled["points"]
        if spts.shape[1] < pts.points_dim:
            spts = np.pad(spts, ((0, 0), (0, pts.points_dim - spts.shape[1])))
        data["points"] = LiDARPoints.cat(
            [LiDARPoints(spts[:, : pts.points_dim], pts.points_dim), pts]
        )
        return data
