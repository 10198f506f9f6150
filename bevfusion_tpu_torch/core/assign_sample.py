"""Assigner / sampler / IoU-calculator registry surface.

Counterpart of ``bevfusion_tpu/core/assign_sample.py`` (reference
mmdet3d/core/bbox/{assigners,samplers,iou_calculators}): the configs use
HungarianAssigner3D (its match costs in ``core/matching.py``),
PseudoSampler and BboxOverlaps3D(coordinate='lidar'). The TransFusion head
calls the functional forms (``core/matching.py``, ``ops/iou3d.py``) itself;
these classes give the registry-driven API, so a config that names them
builds. The IoU calculators and ``HungarianAssigner3D`` compute in torch
(the port's ``iou_3d`` / ``iou_bev`` and auction); the assign results and
the samplers keep the JAX package's host contract (numpy arrays; the
piecewise sampler draws from numpy's ``default_rng``), and
tests/test_torch_core_inventory.py holds each to its JAX counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.iou3d import iou_3d, iou_bev
from ..registry import BBOX_ASSIGNERS, Registry
from .matching import auction_assignment, hungarian_costs

IOU_CALCULATORS = Registry("iou_calculators")
SAMPLERS = Registry("bbox_samplers")

__all__ = ["AssignResult", "BboxOverlaps3D", "BboxOverlapsNearest3D", "PseudoSampler",
           "IoUNegPiecewiseSampler", "HungarianAssigner3D", "HeuristicAssigner3D",
           "IOU_CALCULATORS", "SAMPLERS"]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


@IOU_CALCULATORS.register
class BboxOverlaps3D:
    """3D IoU (rotated BEV overlap x z extent) for LiDAR-frame boxes
    (core/bbox/iou_calculators/iou3d_calculator.py)."""

    def __init__(self, coordinate: str = "lidar"):
        assert coordinate in ("lidar", "camera", "depth")
        self.coordinate = coordinate

    def __call__(self, boxes1, boxes2, mode: str = "iou"):
        return iou_3d(_t(boxes1)[:, :7], _t(boxes2)[:, :7])


@IOU_CALCULATORS.register
class BboxOverlapsNearest3D:
    """BEV IoU with the yaw kept (the reference aligns the yaw to the
    nearest axis; the exact rotated IoU is the JAX package's choice)."""

    def __init__(self, coordinate: str = "lidar"):
        self.coordinate = coordinate

    def __call__(self, boxes1, boxes2, mode: str = "iou"):
        sel = [0, 1, 3, 4, 6]
        return iou_bev(_t(boxes1)[:, sel], _t(boxes2)[:, sel])


class AssignResult(NamedTuple):
    num_gts: int
    gt_inds: np.ndarray  # [num_preds] 1-based gt index, 0 = background
    max_overlaps: np.ndarray
    labels: np.ndarray


class SamplingResult:
    """What a sampler picked: ``pos_inds``, ``neg_inds``,
    ``pos_assigned_gt_inds`` (0-based) and ``pos_gt_bboxes``."""

    def __init__(self, assign_result: AssignResult, pos_inds, neg_inds, gt_bboxes):
        self.pos_inds, self.neg_inds = pos_inds, neg_inds
        self.pos_assigned_gt_inds = np.asarray(assign_result.gt_inds)[pos_inds] - 1
        self.pos_gt_bboxes = np.asarray(gt_bboxes)[self.pos_assigned_gt_inds]


@SAMPLERS.register
class PseudoSampler:
    """No-op sampler: every assigned pred is positive, the rest negative
    (mmdet PseudoSampler; the reference uses it for TransFusion)."""

    def sample(self, assign_result: AssignResult, bboxes, gt_bboxes):
        gt_inds = np.asarray(assign_result.gt_inds)
        return SamplingResult(assign_result, np.nonzero(gt_inds > 0)[0],
                              np.nonzero(gt_inds == 0)[0], gt_bboxes)


@SAMPLERS.register
class IoUNegPiecewiseSampler:
    """IoU piecewise negative sampling (PartA2-style two-stage training;
    core/bbox/samplers/iou_neg_piecewise_sampler.py:9-155): positives
    sampled at random up to num*pos_fraction; negatives drawn from IoU
    pieces bounded by neg_iou_piece_thrs with per-piece fractions, any
    shortfall rolled into the next piece. Host-side (train-data prep),
    numpy RNG."""

    def __init__(self, num, pos_fraction=None, neg_piece_fractions=None,
                 neg_iou_piece_thrs=None, neg_pos_ub=-1,
                 add_gt_as_proposals=False, return_iou=False, seed=None):
        assert isinstance(neg_piece_fractions, (list, tuple))
        assert len(neg_piece_fractions) == len(neg_iou_piece_thrs)
        self.num = int(num)
        self.pos_fraction = pos_fraction
        self.neg_piece_fractions = list(neg_piece_fractions)
        self.neg_iou_thr = list(neg_iou_piece_thrs)
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals
        self.return_iou = return_iou
        self.neg_piece_num = len(self.neg_piece_fractions)
        self._rng = np.random.default_rng(seed)

    def _random_choice(self, gallery: np.ndarray, num: int) -> np.ndarray:
        return self._rng.choice(gallery, size=num, replace=False)

    def _sample_pos(self, assign_result: AssignResult, num_expected: int):
        pos_inds = np.nonzero(np.asarray(assign_result.gt_inds) > 0)[0]
        if len(pos_inds) <= num_expected:
            return pos_inds
        return self._random_choice(pos_inds, num_expected)

    def _sample_neg(self, assign_result: AssignResult, num_expected: int):
        neg_inds = np.nonzero(np.asarray(assign_result.gt_inds) == 0)[0]
        if len(neg_inds) <= num_expected:
            return neg_inds
        choice = np.zeros((0,), np.int64)
        extend = 0
        max_overlaps = np.asarray(assign_result.max_overlaps)[neg_inds]
        for piece in range(self.neg_piece_num):
            if piece == self.neg_piece_num - 1:
                expected = num_expected - len(choice)
                min_thr = 0.0
            else:
                expected = int(num_expected * self.neg_piece_fractions[piece]) + extend
                min_thr = self.neg_iou_thr[piece + 1]
            max_thr = self.neg_iou_thr[piece]
            in_piece = np.nonzero((max_overlaps >= min_thr) & (max_overlaps < max_thr))[0]
            if len(in_piece) < expected:
                choice = np.concatenate([choice, neg_inds[in_piece]])
                extend += expected - len(in_piece)
            else:
                picked = self._random_choice(in_piece, expected)
                choice = np.concatenate([choice, neg_inds[picked]])
                extend = 0
        return choice

    def sample(self, assign_result: AssignResult, bboxes, gt_bboxes, gt_labels=None):
        expected_pos = int(self.num * (self.pos_fraction or 0))
        pos_inds = np.unique(self._sample_pos(assign_result, expected_pos))
        expected_neg = self.num - len(pos_inds)
        if self.neg_pos_ub >= 0:
            expected_neg = min(expected_neg, int(self.neg_pos_ub * max(1, len(pos_inds))))
        neg_inds = np.unique(self._sample_neg(assign_result, expected_neg))
        r = SamplingResult(assign_result, pos_inds, neg_inds, gt_bboxes)
        if self.return_iou:
            r.iou = np.asarray(assign_result.max_overlaps)[np.concatenate([pos_inds, neg_inds])]
        return r


def _result(G: int, P: int, pairs, gt_labels, iou: np.ndarray) -> AssignResult:
    """The assign result of (gt, pred) ``pairs``: 1-based ``gt_inds``, the
    gt's label and the pair's IoU (``iou [P, G]``) at each assigned pred."""
    gt_inds = np.zeros((P,), np.int64)
    labels = np.full((P,), -1, np.int64)
    max_ov = np.zeros((P,), np.float32)
    for g, p in pairs:
        gt_inds[p] = g + 1
        if gt_labels is not None:
            labels[p] = int(np.asarray(gt_labels)[g])
        max_ov[p] = iou[p, g]
    return AssignResult(G, gt_inds, max_ov, labels)


@BBOX_ASSIGNERS.register
class HungarianAssigner3D:
    """Config-compatible wrapper over the auction matcher
    (``core/matching.py``): the reference's focal class cost + BEV L1 +
    -IoU, assigned by the same auction as the TransFusion head's targets."""

    def __init__(self, cls_cost=None, reg_cost=None, iou_cost=None, iou_calculator=None):
        self.cls_cost = cls_cost or {"weight": 0.15, "alpha": 0.25, "gamma": 2.0}
        self.reg_cost = reg_cost or {"weight": 0.25}
        self.iou_cost = iou_cost or {"weight": 0.25}

    def assign(self, bboxes, gt_bboxes, gt_labels, cls_pred, train_cfg):
        bboxes, gt = _t(bboxes), _t(gt_bboxes)
        pcr = train_cfg["point_cloud_range"]
        p0 = torch.tensor(pcr[0:2], dtype=bboxes.dtype)
        span = torch.tensor(pcr[3:5], dtype=bboxes.dtype) - p0
        iou = iou_3d(bboxes[:, :7], gt[:, :7])
        cost = hungarian_costs(
            torch.sigmoid(_t(cls_pred)), (bboxes[:, :2] - p0) / span, (gt[:, :2] - p0) / span,
            iou, _t(gt_labels), cls_weight=self.cls_cost.get("weight", 0.15),
            reg_weight=self.reg_cost.get("weight", 0.25),
            iou_weight=self.iou_cost.get("weight", 0.25))
        G, P = cost.shape
        assign = auction_assignment(cost, torch.ones(G, dtype=torch.bool),
                                    torch.ones(P, dtype=torch.bool)).numpy()
        return _result(G, P, [(g, int(p)) for g, p in enumerate(assign) if p >= 0], gt_labels,
                       iou.numpy())


@BBOX_ASSIGNERS.register
class HeuristicAssigner3D:
    """Nearest-center heuristic assigner
    (core/bbox/assigners/hungarian_assigner.py:38-80): each GT matches
    its nearest same-class prediction within dist_thre meters."""

    def __init__(self, dist_thre: float = 100.0, iou_calculator=None):
        self.dist_thre = float(dist_thre)

    def assign(self, bboxes, gt_bboxes, gt_bboxes_ignore=None, gt_labels=None,
               query_labels=None):
        bboxes = np.asarray(bboxes)
        gt = np.asarray(gt_bboxes)
        G, P = len(gt), len(bboxes)
        dist = np.linalg.norm(bboxes[None, :, :2] - gt[:, None, :2], axis=-1)  # [G, P]
        if query_labels is not None and gt_labels is not None:
            diff = np.asarray(query_labels)[None] != np.asarray(gt_labels)[:, None]
            dist = dist + diff * self.dist_thre
        best = {}
        vals = np.full((P,), 1e4)
        for g in range(G):
            p = int(np.argmin(dist[g]))
            if dist[g, p] <= self.dist_thre and dist[g, p] < vals[p]:
                vals[p] = dist[g, p]
                best[p] = g
        iou = np.zeros((P, max(G, 1)), np.float32)
        if best:
            iou = iou_3d(torch.from_numpy(bboxes[:, :7]), torch.from_numpy(gt[:, :7])).numpy()
        return _result(G, P, [(g, p) for p, g in best.items()], gt_labels, iou)
