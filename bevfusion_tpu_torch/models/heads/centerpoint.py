"""CenterHead (CenterPoint) multi-task detection head (NCHW), eval.

Counterpart of ``SeparateHead`` and ``CenterHead`` (forward and
``get_bboxes``) in ``bevfusion_tpu/models/heads/centerpoint.py``
(reference mmdet3d/models/heads/bbox/centerpoint.py): a shared 3x3
conv-BN-ReLU, then per task group a ``SeparateHead`` of branches (heatmap,
reg, height, dim, rot, vel), each ``num_conv - 1`` 3x3 conv-BN-ReLU and a
final conv with bias (the heatmap's bias starts at -2.19). ``get_bboxes``
decodes each task with ``CenterPointBBoxCoder`` (sigmoid heatmap, ``exp``
of the dims where ``norm_bbox``) and suppresses per task with circle NMS or
rotated BEV NMS (``ops/nms.py``, one kernel launch a task), keeps the top
``post_max_size`` survivors by score, offsets the labels by task and moves
the boxes' gravity center to the bottom center.

Module names follow the reference checkpoint: ``shared_conv.{conv,bn}``,
``task_heads.{t}.{branch}.{i}.{conv,bn}`` and ``task_heads.{t}.{branch}.{n}``
for the final conv. Every sort is stable (``jnp.argsort`` and
``jax.lax.top_k`` keep equal scores in index order). ``DCNSeparateHead``
and the loss are not ported yet (ROADMAP Queue 1 items 6i and 5):
``unported_loss`` names the loss, and ``BEVFusion`` raises in training.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ...core.coders import CenterPointBBoxCoder
from ...ops import nms
from ...registry import HEADS
from ..layers import ConvBNAct

__all__ = ["SeparateHead", "CenterHead"]


class SeparateHead(nn.Module):
    """One task group's branches: ``heads`` maps a branch name to
    (output channels, number of convs)."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]], head_conv: int = 64,
                 final_kernel: int = 3, init_bias: float = -2.19):
        super().__init__()
        self.names = list(heads)
        pad = final_kernel // 2
        for name, (classes, num_conv) in heads.items():
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvBNAct(c, head_conv, final_kernel, 1, pad))
                c = head_conv
            last = nn.Conv2d(c, classes, final_kernel, 1, pad)
            nn.init.constant_(last.bias, init_bias if name == "heatmap" else 0.0)
            self.add_module(name, nn.Sequential(*layers, last))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x) for name in self.names}


def _rank(keep: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Each detection's rank [P, N] among the kept ones by descending score
    (the dropped ones after them), equal scores in index order."""
    order = nms.score_order(scores, keep)
    ranks = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, ranks)


@HEADS.register
class CenterHead(nn.Module):
    unported_loss = "CenterHead.loss (bevfusion_tpu/models/heads/centerpoint.py:166-237)"

    def __init__(self, in_channels: int = 128, tasks: Sequence[Sequence[str]] = (),
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None, common_heads: Optional[dict] = None,
                 loss_cls: Optional[dict] = None, loss_bbox: Optional[dict] = None,
                 separate_head: Optional[dict] = None, share_conv_channel: int = 64,
                 num_heatmap_convs: int = 2, norm_bbox: bool = True):
        """``train_cfg``, ``loss_cls`` and ``loss_bbox`` belong to the loss,
        which is not ported yet."""
        super().__init__()
        sep = dict(separate_head or {})
        if sep.pop("type", None) == "DCNSeparateHead":
            raise NotImplementedError("CenterHead: DCNSeparateHead (DeformConv2dPack) is not "
                                      "ported yet (ROADMAP Queue 1 item 6i); no config uses it")
        sep_kw = {k: v for k, v in sep.items() if k in ("head_conv", "final_kernel", "init_bias")}
        self.tasks = [list(t) for t in tasks]
        self.test_cfg = dict(test_cfg or {})
        self.norm_bbox = norm_bbox
        coder_cfg = dict(bbox_coder or {})
        coder_cfg.pop("type", None)
        coder_cfg["pc_range"] = coder_cfg["pc_range"][:2]
        self.coder = CenterPointBBoxCoder(**coder_cfg)

        self.shared_conv = ConvBNAct(in_channels, share_conv_channel, 3, 1, 1)
        self.task_heads = nn.ModuleList()
        for names in self.tasks:
            heads = {k: tuple(v) for k, v in (common_heads or {}).items()}
            heads["heatmap"] = (len(names), num_heatmap_convs)
            self.task_heads.append(SeparateHead(share_conv_channel, heads, **sep_kw))

    def forward(self, feats: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """feats [B, Cin, H, W] -> per task a dict of maps [B, c, H, W]."""
        x = self.shared_conv(feats)
        return [head(x) for head in self.task_heads]

    def _decode_task(self, t: int, pred: Dict[str, torch.Tensor]):
        """Task ``t``'s decode and its NMS's input to the greedy pass:
        (boxes [B, K, 9] gravity center, scores, labels, valid: the
        detections the NMS may keep, sup [B, K, K], order [B, K])."""
        tcfg = self.test_cfg
        dim = pred["dim"].float()
        if self.norm_bbox:
            dim = dim.exp()
        rot = pred["rot"].float()
        dec = self.coder.decode(pred["heatmap"].float().sigmoid(), rot[:, 0:1], rot[:, 1:2],
                                pred["height"].float(), dim, pred["vel"].float(),
                                reg=pred["reg"].float())
        boxes, scores, labels, valid = (dec[k] for k in ("bboxes", "scores", "labels", "mask"))
        nms_type = tcfg.get("nms_type")
        if isinstance(nms_type, (list, tuple)):
            nms_type = nms_type[t]
        if nms_type == "circle":
            # the reference compares min_radius with the SQUARED center
            # distance (box3d_nms.py:216-218, centerpoint.py:711-713)
            sup, order = nms.circle_suppression(boxes[..., :2].contiguous(), scores, valid,
                                                tcfg["min_radius"][t])
        else:
            scale = (tcfg.get("nms_scale") or [[1.0] * len(tk) for tk in self.tasks])[t]
            scales = torch.tensor(scale, dtype=boxes.dtype, device=boxes.device)
            sc = scales[labels.long().clamp(0, len(scale) - 1)]
            bev = torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 3] * sc,
                               boxes[..., 4] * sc, boxes[..., 6]], -1)
            valid = valid & (scores >= tcfg.get("score_threshold", 0.0))
            sup, order = nms.bev_suppression(bev, scores, valid, tcfg["nms_thr"])
        return boxes, scores, labels, valid, sup, order

    def suppressions(self, preds: List[Dict[str, torch.Tensor]]):
        """Each task's (suppression matrix, score order): what ``get_bboxes``
        hands the greedy pass."""
        return [self._decode_task(t, pred)[-2:] for t, pred in enumerate(preds)]

    def get_bboxes(self, preds: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """Decode and per-task NMS. Returns {"bboxes" [B, T*K, 9] bottom
        center, "scores", "labels" (offset by task), "mask"} over the T
        tasks' K = ``max_num`` decoded boxes each; ``mask`` marks the kept."""
        post_max = self.test_cfg.get("post_max_size", 83)
        outs, flag = [], 0
        for t, pred in enumerate(preds):
            boxes, scores, labels, valid, sup, order = self._decode_task(t, pred)
            keep = nms.greedy_suppress(sup, order) & valid
            outs.append((boxes, scores, labels + flag, keep & (_rank(keep, scores) < post_max)))
            flag += len(self.tasks[t])
        boxes = torch.cat([o[0] for o in outs], 1)
        # gravity center -> bottom center at the merge (centerpoint.py:745-747)
        boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] - boxes[..., 5:6] * 0.5,
                           boxes[..., 3:]], -1)
        return {"bboxes": boxes, "scores": torch.cat([o[1] for o in outs], 1),
                "labels": torch.cat([o[2] for o in outs], 1),
                "mask": torch.cat([o[3] for o in outs], 1)}
