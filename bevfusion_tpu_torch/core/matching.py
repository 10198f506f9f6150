"""Hungarian matching of the TransFusion head: the cost matrix and an
auction-algorithm assignment.

Counterpart of ``bevfusion_tpu/core/matching.py`` (reference
HungarianAssigner3D, mmdet3d/core/bbox/assigners/hungarian_assigner.py:
85-143, which ships the cost to scipy on the host). The auction runs with
the JAX package's single eps phase, bids and tie-breaks, so both packages
return the same assignment; a scipy matcher could pick another optimum.

The JAX ``lax.while_loop`` is one hand-written kernel on the card
(``csrc/auction.cu`` through ``ops/auction.py``, re-exported here): every
round of a problem in one block, the stop test on the device, one launch a
call and no host sync. CPU tensors take its plain version
(``auction_assignment_plain``), a Python loop of tensor ops.
"""
from __future__ import annotations

import torch

from ..ops.auction import auction_assignment, auction_assignment_plain

__all__ = ["auction_assignment", "auction_assignment_plain", "hungarian_costs"]


def hungarian_costs(cls_score: torch.Tensor, boxes_norm_xy: torch.Tensor,
                    gt_norm_xy: torch.Tensor, iou: torch.Tensor, gt_labels: torch.Tensor,
                    cls_weight: float = 0.15, reg_weight: float = 0.25, iou_weight: float = 0.25,
                    alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """The reference's cost (focal class cost + BEV L1 + -IoU,
    hungarian_assigner.py:14-35, 117-124) as [num_gts, num_proposals].
    cls_score [P, ncls] sigmoid scores; *_norm_xy centers scaled to [0, 1];
    iou [P, G]."""
    neg = -torch.log(torch.clamp(1 - cls_score, min=eps)) * (1 - alpha) * cls_score ** gamma
    pos = -torch.log(torch.clamp(cls_score, min=eps)) * alpha * (1 - cls_score) ** gamma
    cls_cost = (pos - neg)[:, gt_labels.long()]
    reg_cost = (boxes_norm_xy[:, None, :] - gt_norm_xy[None, :, :]).abs().sum(-1)
    return (cls_weight * cls_cost + reg_weight * reg_cost + iou_weight * (-iou)).t()
