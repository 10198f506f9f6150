"""CenterHead (CenterPoint) multi-task detection head (NCHW).

Counterpart of ``SeparateHead`` and ``CenterHead`` (forward, ``loss`` and
``get_bboxes``) in ``bevfusion_tpu/models/heads/centerpoint.py``
(reference mmdet3d/models/heads/bbox/centerpoint.py): a shared 3x3
conv-BN-ReLU, then per task group a ``SeparateHead`` of branches (heatmap,
reg, height, dim, rot, vel), each ``num_conv - 1`` 3x3 conv-BN-ReLU and a
final conv with bias (the heatmap's bias starts at -2.19). ``get_bboxes``
decodes each task with ``CenterPointBBoxCoder`` (sigmoid heatmap, ``exp``
of the dims where ``norm_bbox``) and suppresses per task with circle NMS or
rotated BEV NMS (``ops/nms.py``, one kernel launch a task), keeps the top
``post_max_size`` survivors by score, offsets the labels by task and moves
the boxes' gravity center to the bottom center. ``loss`` draws each task's
gaussian heatmap targets at the boxes' integer centers and takes the
gaussian focal loss on the heatmaps and the L1 loss on the regression maps
gathered there.

Module names follow the reference checkpoint: ``shared_conv.{conv,bn}``,
``task_heads.{t}.{branch}.{i}.{conv,bn}`` and ``task_heads.{t}.{branch}.{n}``
for the final conv. Every sort is stable (``jnp.argsort`` and
``jax.lax.top_k`` keep equal scores in index order). ``DCNSeparateHead``
is not ported yet (ROADMAP Queue 1 #9, the long tail); no config uses it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ...core.coders import CenterPointBBoxCoder
from ...ops import nms
from ...ops.gaussian import draw_heatmap_gaussians, gaussian_radius
from ...registry import HEADS
from ..layers import ConvBNAct, at_least_fp32
from ..losses import clip_sigmoid, gaussian_focal_loss, l1_loss

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
    def __init__(self, in_channels: int = 128, tasks: Sequence[Sequence[str]] = (),
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None, common_heads: Optional[dict] = None,
                 loss_cls: Optional[dict] = None, loss_bbox: Optional[dict] = None,
                 separate_head: Optional[dict] = None, share_conv_channel: int = 64,
                 num_heatmap_convs: int = 2, norm_bbox: bool = True):
        """``loss_cls`` and ``loss_bbox`` name the losses ``loss`` computes
        (gaussian focal, L1, as the JAX package fixes them; ``loss_bbox``'s
        ``loss_weight`` is not read there either)."""
        super().__init__()
        sep = dict(separate_head or {})
        if sep.pop("type", None) == "DCNSeparateHead":
            raise NotImplementedError("CenterHead: DCNSeparateHead (DeformConv2dPack) is not "
                                      "ported yet (ROADMAP Queue 1 #9); no config uses it")
        sep_kw = {k: v for k, v in sep.items() if k in ("head_conv", "final_kernel", "init_bias")}
        self.tasks = [list(t) for t in tasks]
        self.train_cfg = dict(train_cfg or {})
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

    def _task_of_label(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """label -> (task, class within the task) lookup tables."""
        pairs = [(t, c) for t, names in enumerate(self.tasks) for c in range(len(names))]
        return tuple(torch.tensor(v, dtype=torch.long, device=device) for v in zip(*pairs))

    def loss(self, preds: List[Dict[str, torch.Tensor]], gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gt_boxes [B, G, 9] (x, y, z bottom, w, l, h, yaw, vx, vy); gt_labels
        [B, G] int; gt_valid [B, G] bool. Returns ``heatmap/task{t}`` (gaussian
        focal loss over the positives, the cells where the target is 1) and
        ``bbox/task{t}`` (L1 of the reg, height, dim, rot, vel maps at the
        boxes' integer centers against the targets, over the boxes) for each
        task, as the JAX package's ``CenterHead.loss`` (centerpoint.py:166-237;
        reference centerpoint.py:585-634). A box counts where it is valid, its
        integer center (truncated toward zero, as ``astype(int32)``) lies on
        the map and its size is positive; labels are clipped into the task
        table. The L1 term is weighted by ``code_weights`` only: the config's
        ``loss_bbox.loss_weight`` is ignored, as in the JAX package (an
        inherited divergence, ROADMAP Queue 3). The targets carry no
        gradient."""
        cfg = self.train_cfg
        osf = cfg["out_size_factor"]
        vx, vy = cfg["voxel_size"][0], cfg["voxel_size"][1]
        pcr = cfg["point_cloud_range"]
        fX, fY = cfg["grid_size"][0] // osf, cfg["grid_size"][1] // osf
        dev = gt_boxes.device
        code_weights = torch.tensor(cfg["code_weights"], dtype=torch.float32, device=dev)
        t_of, c_of = self._task_of_label(dev)
        with torch.no_grad():
            boxes = at_least_fp32(gt_boxes)
            gz = boxes[..., 2] + boxes[..., 5] * 0.5  # gravity center (centerpoint.py:448-450)
            coor_x = (boxes[..., 0] - pcr[0]) / vx / osf
            coor_y = (boxes[..., 1] - pcr[1]) / vy / osf
            ix, iy = coor_x.to(torch.int32), coor_y.to(torch.int32)  # toward zero
            in_range = (ix >= 0) & (ix < fX) & (iy >= 0) & (iy < fY)
            wf, lf = boxes[..., 3] / vx / osf, boxes[..., 4] / vy / osf
            radius = torch.clamp(gaussian_radius((lf, wf), cfg["gaussian_overlap"]).to(
                torch.int32), min=cfg["min_radius"])
            ok = gt_valid.bool() & in_range & (wf > 0) & (lf > 0)
            ind = (ix.long() * fY + iy.long()).clamp(0, fX * fY - 1)  # centerpoint.py:560
            dims = boxes[..., 3:6]
            if self.norm_bbox:
                dims = torch.log(torch.clamp(dims, min=1e-8))
            anno = torch.cat([(coor_x - ix)[..., None], (coor_y - iy)[..., None], gz[..., None],
                              dims, torch.sin(boxes[..., 6:7]), torch.cos(boxes[..., 6:7]),
                              boxes[..., 7:9]], -1)  # [B, G, 10]
            label = gt_labels.long().clamp(0, len(t_of) - 1)
            gt_task, gt_cls = t_of[label], c_of[label]
            centers = torch.stack([iy, ix], -1)  # (x, y) = (last, second-to-last) of [X, Y]

        losses = {}
        for t, pred in enumerate(preds):
            with torch.no_grad():
                m_t = ok & (gt_task == t)
                empty = torch.zeros((len(self.tasks[t]), fX, fY), dtype=torch.float32, device=dev)
                hm = torch.stack([draw_heatmap_gaussians(empty, centers[b], radius[b], gt_cls[b],
                                                         m_t[b]) for b in range(len(m_t))])
                num_pos = torch.clamp((hm == 1.0).sum().float(), min=1.0)
                w = m_t[..., None].float() * code_weights
                num = m_t.float().sum()
            losses[f"heatmap/task{t}"] = gaussian_focal_loss(clip_sigmoid(pred["heatmap"]), hm,
                                                             avg_factor=num_pos)
            maps = torch.cat([pred[k] for k in ("reg", "height", "dim", "rot", "vel")], 1)
            gathered = maps.flatten(2).gather(
                2, ind[:, None, :].expand(-1, maps.shape[1], -1)).transpose(1, 2)  # [B, G, 10]
            losses[f"bbox/task{t}"] = l1_loss(gathered, anno, weight=w, avg_factor=num + 1e-4)
        return losses

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
