"""Hungarian matching of the TransFusion head: the cost matrix and an
auction-algorithm assignment.

Counterpart of ``bevfusion_tpu/core/matching.py`` (reference
HungarianAssigner3D, mmdet3d/core/bbox/assigners/hungarian_assigner.py:
85-143, which ships the cost to scipy on the host). The auction runs on
the tensors' device with the JAX package's single eps phase, bids and
tie-breaks, so both packages return the same assignment; a scipy matcher
could pick another optimum.

The JAX ``while_loop`` is a Python loop here. Whether a row is still
unassigned is read on the host every ``_CHECK_EVERY`` rounds (one device
sync each); a round in which no row bids changes nothing, so the
assignment is the one the JAX loop returns.
"""
from __future__ import annotations

import torch

__all__ = ["auction_assignment", "hungarian_costs"]

_BIG = 1e9
_CHECK_EVERY = 8  # auction rounds between two host reads of the stop flag


def auction_assignment(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                       eps_scale: float = 0.002, max_iters: int = 2000) -> torch.Tensor:
    """Minimise sum of cost[r, assign[r]] over valid rows and columns.

    cost [R, C] (R = ground truths, C = proposals). Returns assign [R]
    int64, the column of each row or -1 (unassigned or invalid). Forward
    auction on v = -cost from zero prices with one eps = spread *
    eps_scale / R: within spread * eps_scale of the optimum."""
    R, C = cost.shape
    dev = cost.device
    value = -torch.where(row_valid[:, None] & col_valid[None, :], cost.float(),
                         torch.tensor(_BIG, device=dev))
    finite = torch.where(value > -_BIG / 2, value, torch.tensor(float("inf"), device=dev))
    spread = torch.clamp(value.max() - finite.min(), min=1.0)
    eps = spread * eps_scale / max(R, 1)
    rows = torch.arange(R, device=dev)
    cols = torch.arange(C, device=dev)
    price = torch.zeros(C, device=dev)
    owner = torch.full((C,), -1, dtype=torch.long, device=dev)
    assign = torch.full((R,), -1, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    it = 0
    while it < max_iters and bool(((assign < 0) & row_valid).any()):
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            net = value - price[None, :]
            best_v, best_j = net.max(1)
            second_v = net.scatter(1, best_j[:, None], float("-inf")).max(1).values
            bid = best_v - second_v + eps
            bidding = (assign < 0) & row_valid
            bid_amt = torch.where(bidding, bid, neg_inf)
            col_best_bid = torch.full((C + 1,), float("-inf"), device=dev).scatter_reduce(
                0, torch.where(bidding, best_j, C), bid_amt, "amax")[:C]
            is_winner = bidding & (bid_amt == col_best_bid[best_j])
            win_row = torch.full((C + 1,), R, dtype=torch.long, device=dev).scatter_reduce(
                0, torch.where(is_winner, best_j, C), torch.where(is_winner, rows, R),
                "amin")[:C]
            got_bid = win_row < R
            owner = torch.where(got_bid, win_row, owner)
            price = torch.where(got_bid, price + col_best_bid, price)
            assign = torch.full((R + 1,), -1, dtype=torch.long, device=dev)
            assign[torch.where(owner >= 0, owner, R)] = cols
            assign = assign[:R]
            it += 1
    return torch.where(row_valid, assign, -1)


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
