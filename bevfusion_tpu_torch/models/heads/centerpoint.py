"""CenterHead (CenterPoint) multi-task detection head (NCHW).

Counterpart of ``SeparateHead`` and ``CenterHead`` (forward, ``loss`` and
``get_bboxes``) in ``bevfusion_tpu/models/heads/centerpoint.py``
(reference mmdet3d/models/heads/bbox/centerpoint.py): a shared 3x3
conv-BN-ReLU, then per task group a ``SeparateHead`` of branches (heatmap,
reg, height, dim, rot, vel), each ``num_conv - 1`` 3x3 conv-BN-ReLU and a
final conv with bias (the heatmap's bias starts at -2.19). ``get_bboxes``
decodes each task with ``CenterPointBBoxCoder`` (sigmoid heatmap, ``exp``
of the dims where ``norm_bbox``) and suppresses per task with circle NMS or
rotated BEV NMS (``ops/nms.py``: the frame's tasks as the problems of one
launch of each NMS kernel, N1 and N2), keeps the top
``post_max_size`` survivors by score, offsets the labels by task and moves
the boxes' gravity center to the bottom center. ``loss`` draws each task's
gaussian heatmap targets at the boxes' integer centers and takes the
gaussian focal loss on the heatmaps and the L1 loss on the regression maps
gathered there.

Module names follow the reference checkpoint: ``shared_conv.{conv,bn}``,
``task_heads.{t}.{branch}.{i}.{conv,bn}`` and ``task_heads.{t}.{branch}.{n}``
for the final conv. Every sort is stable (``jnp.argsort`` and
``jax.lax.top_k`` keep equal scores in index order). With
``separate_head.type: DCNSeparateHead`` each task's branches are a
``DCNSeparateHead`` (reference centerpoint.py:130-246): two deformable 3x3
feature adapters (``feature_adapt_cls``, ``feature_adapt_reg``; the D1
kernel on the card), the heatmap from ``cls_head`` (a 3x3 conv-BN-ReLU and a
3x3 conv with bias -2.19) and the other branches from ``task_head``, a
``SeparateHead`` without the heatmap.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ... import parallel
from ...core.coders import CenterPointBBoxCoder
from ...ops import nms
from ...ops.deform_conv import DeformConv2dPack
from ...ops.gaussian import draw_heatmap_gaussians, gaussian_radius
from ...registry import HEADS
from ..layers import ConvBNAct, at_least_fp32
from ..losses import clip_sigmoid, gaussian_focal_loss, l1_loss

__all__ = ["SeparateHead", "DCNSeparateHead", "CenterHead"]


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


class DCNSeparateHead(nn.Module):
    """One task group's branches behind two deformable feature adapters:
    ``heads`` as ``SeparateHead``'s (its "heatmap" entry is replaced by
    ``cls_head``, ``num_cls`` channels)."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]], num_cls: int,
                 head_conv: int = 64, final_kernel: int = 3, init_bias: float = -2.19):
        super().__init__()
        self.feature_adapt_cls = DeformConv2dPack(in_channels, in_channels, 3)
        self.feature_adapt_reg = DeformConv2dPack(in_channels, in_channels, 3)
        last = nn.Conv2d(head_conv, num_cls, 3, 1, 1)
        nn.init.constant_(last.bias, init_bias)
        self.cls_head = nn.Sequential(ConvBNAct(in_channels, head_conv, 3, 1, 1), last)
        self.task_head = SeparateHead(in_channels, {k: v for k, v in heads.items()
                                                    if k != "heatmap"},
                                      head_conv, final_kernel)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.task_head(self.feature_adapt_reg(x))
        out["heatmap"] = self.cls_head(self.feature_adapt_cls(x))
        return out


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
        dcn = sep.pop("type", None) == "DCNSeparateHead"
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
            self.task_heads.append(
                DCNSeparateHead(share_conv_channel, heads, len(names), **sep_kw) if dcn
                else SeparateHead(share_conv_channel, heads, **sep_kw))

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
                # the global batch's counts under data parallelism
                num_pos = torch.clamp(parallel.count_sum((hm == 1.0).sum().float()), min=1.0)
                w = m_t[..., None].float() * code_weights
                num = parallel.count_sum(m_t.float().sum())
            losses[f"heatmap/task{t}"] = gaussian_focal_loss(clip_sigmoid(pred["heatmap"]), hm,
                                                             avg_factor=num_pos)
            maps = torch.cat([pred[k] for k in ("reg", "height", "dim", "rot", "vel")], 1)
            gathered = maps.flatten(2).gather(
                2, ind[:, None, :].expand(-1, maps.shape[1], -1)).transpose(1, 2)  # [B, G, 10]
            losses[f"bbox/task{t}"] = l1_loss(gathered, anno, weight=w, avg_factor=num + 1e-4)
        return losses

    def _decode_task(self, t: int, pred: Dict[str, torch.Tensor]):
        """Task ``t``'s decode and its NMS problems: (boxes [B, K, 9] gravity
        center, scores, labels, valid: the detections the NMS may keep, N1's
        rows [B, K, 9] in index order, rotated: the task's NMS mode, its
        threshold)."""
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
            return (boxes, scores, labels, valid, nms.center_geometry(boxes[..., :2]), False,
                    tcfg["min_radius"][t])
        scale = (tcfg.get("nms_scale") or [[1.0] * len(tk) for tk in self.tasks])[t]
        scales = torch.tensor(scale, dtype=boxes.dtype, device=boxes.device)
        sc = scales[labels.long().clamp(0, len(scale) - 1)]
        bev = torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 3] * sc,
                           boxes[..., 4] * sc, boxes[..., 6]], -1)
        valid = valid & (scores >= tcfg.get("score_threshold", 0.0))
        return boxes, scores, labels, valid, nms.box_geometry(bev), True, tcfg["nms_thr"]

    def _nms_problems(self, preds: List[Dict[str, torch.Tensor]]):
        """Every task's decode, and the frame's NMS as T * B problems of K
        detections (task-major): (the decodes, N1's operands geom [T*B, K, 9]
        in score order, rotated [T*B], thr [T*B], the score order [T*B, K],
        valid [T*B, K])."""
        decs = [self._decode_task(t, pred) for t, pred in enumerate(preds)]
        B, dev = decs[0][0].shape[0], decs[0][0].device
        scores = torch.cat([d[1] for d in decs])
        valid = torch.cat([d[3] for d in decs])
        order = nms.score_order(scores, valid)
        geom = torch.gather(torch.cat([d[4] for d in decs]), 1,
                            order[..., None].expand(-1, -1, nms.GEOM)).contiguous()
        rotated = torch.tensor([d[5] for d in decs for _ in range(B)], device=dev)
        thr = torch.tensor([float(d[6]) for d in decs for _ in range(B)], dtype=torch.float32,
                           device=dev)
        return decs, (geom, rotated, thr), order, valid

    def nms_inputs(self, preds: List[Dict[str, torch.Tensor]]):
        """What ``get_bboxes`` hands N1, and the score order: (geom, rotated,
        thr, order), the tasks' problems stacked task-major."""
        _, words_args, order, _ = self._nms_problems(preds)
        return (*words_args, order)

    def suppressions(self, preds: List[Dict[str, torch.Tensor]]):
        """What ``get_bboxes`` hands N2: (words [T*B, K, ceil(K / 64)],
        the score order [T*B, K])."""
        _, words_args, order, _ = self._nms_problems(preds)
        return nms.suppression_words(*words_args), order

    def get_bboxes(self, preds: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """Decode and per-task NMS. Returns {"bboxes" [B, T*K, 9] bottom
        center, "scores", "labels" (offset by task), "mask"} over the T
        tasks' K = ``max_num`` decoded boxes each; ``mask`` marks the kept.
        The tasks' NMS problems go through one launch of each NMS kernel."""
        post_max = self.test_cfg.get("post_max_size", 83)
        decs, words_args, order, valid = self._nms_problems(preds)
        keeps = (nms.greedy_suppress_words(nms.suppression_words(*words_args), order)
                 & valid).chunk(len(decs))
        outs, flag = [], 0
        for t, ((boxes, scores, labels, *_), keep) in enumerate(zip(decs, keeps)):
            outs.append((boxes, scores, labels + flag, keep & (_rank(keep, scores) < post_max)))
            flag += len(self.tasks[t])
        boxes = torch.cat([o[0] for o in outs], 1)
        # gravity center -> bottom center at the merge (centerpoint.py:745-747)
        boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] - boxes[..., 5:6] * 0.5,
                           boxes[..., 3:]], -1)
        return {"bboxes": boxes, "scores": torch.cat([o[1] for o in outs], 1),
                "labels": torch.cat([o[2] for o in outs], 1),
                "mask": torch.cat([o[3] for o in outs], 1)}
