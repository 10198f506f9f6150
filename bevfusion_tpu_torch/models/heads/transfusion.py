"""TransFusion detection head (NCHW).

Counterpart of ``TransFusionHead.__call__``, ``loss`` and ``get_bboxes``
in ``bevfusion_tpu/models/heads/transfusion.py`` (reference
mmdet3d/models/heads/bbox/transfusion.py): dense class heatmap ->
max-pool local-max filter (nuScenes classes 8/9 exempt, :248-256) ->
top ``num_proposals`` queries over classes x cells -> transformer decoder
over the flattened BEV tokens -> FFN prediction branches -> decode; in
training, Hungarian targets per decoder layer (auction matcher), the
dense gaussian heatmap target and the focal / L1 losses.

The top-k is a stable descending sort, so equal scores are taken in
index order as ``jax.lax.top_k`` takes them. NMS (``nms_type`` set) is
not ported yet.

At any compute dtype the heatmap sigmoid, the proposals' scores, the
query and BEV positions and the centers (the positions added) are fp32
(or wider); the JAX package adds the positions to bf16 centers
(``heads/transfusion.py:139``), which rounds a center to bf16.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import parallel
from ...core.coders import TransFusionBBoxCoder
from ...core.matching import auction_assignment, hungarian_costs
from ...ops.gaussian import draw_heatmap_gaussians, gaussian_radius
from ...ops.iou3d import iou_3d
from ...registry import HEADS
from ..layers import ConvBNAct, at_least_fp32
from ..losses import clip_sigmoid, gaussian_focal_loss, l1_loss, sigmoid_focal_loss
from .transformer import FFNHead, TransformerDecoderLayer


@HEADS.register
class TransFusionHead(nn.Module):
    def __init__(self, num_proposals: int = 128, auxiliary: bool = True,
                 in_channels: int = 384, hidden_channel: int = 128, num_classes: int = 4,
                 num_decoder_layers: int = 3, num_heads: int = 8, nms_kernel_size: int = 1,
                 ffn_channel: int = 256, dropout: float = 0.1, bn_momentum: float = 0.1,
                 activation: str = "relu", common_heads: Optional[dict] = None,
                 num_heatmap_convs: int = 2, train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None, bbox_coder: Optional[dict] = None,
                 **loss_cfg):
        """``loss_cfg`` takes the config's ``loss_*`` keys, which name the
        losses ``loss`` computes (sigmoid focal, gaussian focal, L1, as the
        JAX package fixes them); ``dropout`` is active in training only."""
        super().__init__()
        self.num_proposals = num_proposals
        self.auxiliary = auxiliary
        self.num_classes = num_classes
        self.num_decoder_layers = num_decoder_layers
        self.train_cfg = dict(train_cfg or {})
        self.nms_kernel_size = nms_kernel_size
        self.test_cfg = dict(test_cfg or {})
        coder_cfg = dict(bbox_coder or {})
        coder_cfg.pop("type", None)
        self.coder = TransFusionBBoxCoder(**coder_cfg)

        self.shared_conv = nn.Conv2d(in_channels, hidden_channel, 3, 1, 1)
        self.heatmap_head = nn.Sequential(
            ConvBNAct(hidden_channel, hidden_channel, 3, 1, 1),
            nn.Conv2d(hidden_channel, num_classes, 3, 1, 1))
        self.class_encoding = nn.Conv1d(num_classes, hidden_channel, 1)
        heads = {k: tuple(v) for k, v in (common_heads or {}).items()}
        heads["heatmap"] = (num_classes, num_heatmap_convs)
        self.decoder = nn.ModuleList(
            TransformerDecoderLayer(hidden_channel, num_heads, ffn_channel, activation,
                                    bn_momentum, dropout) for _ in range(num_decoder_layers))
        self.prediction_heads = nn.ModuleList(
            FFNHead(hidden_channel, heads, 64, bn_momentum=bn_momentum)
            for _ in range(num_decoder_layers))

    def forward(self, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """feats [B, Cin, H, W]. Returns the branches [B, P_total, c], the
        selected queries' heatmap scores [B, P, ncls], their labels [B, P]
        and ``dense_heatmap`` logits [B, ncls, H, W]."""
        B, _, H, W = feats.shape
        P, ncls = self.num_proposals, self.num_classes
        lidar_feat = self.shared_conv(feats)
        flat = lidar_feat.flatten(2).transpose(1, 2)  # [B, H*W, C] BEV tokens
        dense_heatmap = self.heatmap_head(lidar_feat)

        heatmap = at_least_fp32(dense_heatmap.detach()).sigmoid()
        pad = self.nms_kernel_size // 2
        local_max = torch.zeros_like(heatmap)
        local_max[:, :, pad:H - pad, pad:W - pad] = F.max_pool2d(
            heatmap, self.nms_kernel_size, stride=1, padding=0)
        dataset = self.test_cfg.get("dataset")
        exempt = {"nuScenes": (8, 9), "Waymo": (1, 2)}.get(dataset, ())
        if ncls >= (10 if dataset == "nuScenes" else 3):
            for c in exempt:
                local_max[:, c] = heatmap[:, c]
        heatmap = heatmap * (heatmap == local_max)

        top = self._proposals(heatmap.reshape(B, -1), P)
        top_cls = top // (H * W)
        top_idx = top % (H * W)
        query_feat = flat.gather(1, top_idx[..., None].expand(-1, -1, flat.shape[-1]))
        onehot = F.one_hot(top_cls, ncls).to(feats.dtype).transpose(1, 2)
        query_feat = query_feat + self.class_encoding(onehot).transpose(1, 2)

        pos_dtype = heatmap.dtype  # fp32, or float64 in a float64 model
        query_pos = torch.stack([top_idx // W, top_idx % W], -1).to(pos_dtype) + 0.5
        gx, gy = torch.meshgrid(torch.arange(H, device=feats.device),
                                torch.arange(W, device=feats.device), indexing="ij")
        bev_pos = (torch.stack([gx, gy], -1).reshape(1, H * W, 2).to(pos_dtype) + 0.5
                   ).expand(B, -1, -1)

        layers = []
        for decoder, ffn in zip(self.decoder, self.prediction_heads):
            query_feat = decoder(query_feat, flat, query_pos, bev_pos)
            res = ffn(query_feat.transpose(1, 2))
            res["center"] = at_least_fp32(res["center"]) + query_pos
            layers.append(res)
            query_pos = res["center"].detach()
        if self.auxiliary:
            out = {k: torch.cat([r[k] for r in layers], 1) for k in layers[0]}
        else:
            out = layers[-1]
        out["query_heatmap_score"] = heatmap.flatten(2).gather(
            2, top_idx[:, None].expand(-1, ncls, -1)).transpose(1, 2)
        out["dense_heatmap"] = dense_heatmap
        out["query_labels"] = top_cls
        return out

    def _proposals(self, scores: torch.Tensor, P: int) -> torch.Tensor:
        """The ``P`` best of ``scores`` [B, ncls*H*W] (the peak-filtered
        heatmap, class-major) per sample, best first, ties to the lower
        index: the flat indices of the queries."""
        return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :P]

    def loss(self, preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gt_boxes [B, G, 9] (x, y, z bottom, w, l, h, yaw, vx, vy);
        gt_labels [B, G] int; gt_valid [B, G] bool. Returns
        ``loss_heatmap``, ``layer_{i}_loss_cls`` / ``layer_{i}_loss_bbox``
        per decoder layer (the last named ``layer_-1``) and
        ``matched_ious``, as the reference's TransFusionHead.loss
        (transfusion.py:587-713). The targets are computed without
        gradient, as the JAX package's reach the loss only through
        constants."""
        P, ncls = self.num_proposals, self.num_classes
        n_layers = self.num_decoder_layers if self.auxiliary else 1
        heat = preds["heatmap"]  # [B, P_total, ncls] logits
        with torch.no_grad():
            targets = [self._targets(b, preds, gt_boxes[b], gt_labels[b], gt_valid[b], n_layers)
                       for b in range(heat.shape[0])]
        labels_t, bt_t, bw_t, npos, iou_t, hm_t = (torch.stack(t) for t in zip(*targets))
        # the batch's normalisers are the global batch's under data parallelism
        num_pos = torch.clamp(parallel.count_sum(npos.sum().float()), min=1.0)

        losses = {"loss_heatmap": gaussian_focal_loss(
            clip_sigmoid(preds["dense_heatmap"]), hm_t,
            avg_factor=torch.clamp(parallel.count_sum((hm_t == 1.0).sum().float()), min=1.0))}
        code_weights = torch.tensor(self.train_cfg["code_weights"], dtype=torch.float32,
                                    device=heat.device)
        branches = ["center", "height", "dim", "rot"] + (["vel"] if "vel" in preds else [])
        for layer in range(n_layers):
            prefix = "layer_-1" if layer == n_layers - 1 else f"layer_{layer}"
            sl = slice(layer * P, (layer + 1) * P)
            losses[f"{prefix}_loss_cls"] = sigmoid_focal_loss(
                heat[:, sl].reshape(-1, ncls), labels_t[:, sl].reshape(-1), avg_factor=num_pos)
            pred_cat = torch.cat([preds[k][:, sl] for k in branches], -1)
            losses[f"{prefix}_loss_bbox"] = l1_loss(
                pred_cat, bt_t[:, sl], weight=bw_t[:, sl] * code_weights, avg_factor=num_pos)
        losses["matched_ious"] = parallel.count_sum(iou_t.sum()) / num_pos
        return losses

    def _targets(self, b: int, preds, boxes, labels, valid, n_layers: int):
        """Sample ``b``'s targets: per decoder layer the matched labels
        [P] (``num_classes`` = background), box targets and weights
        [P, code_size], positive count and matched IoUs [P], concatenated
        over layers; and the dense gaussian heatmap [ncls, X, Y]."""
        cfg, coder = self.train_cfg, self.coder
        P, ncls = self.num_proposals, self.num_classes
        dev = boxes.device
        heat = preds["heatmap"][b]

        def tx(key):
            return preds[key][b].t()[None]

        vel = tx("vel") if "vel" in preds else None
        pred_boxes = coder.decode(heat.t()[None], tx("rot"), tx("dim"), tx("center"),
                                  tx("height"), vel)["bboxes"][0]  # [P_total, 9]
        pcr = cfg["point_cloud_range"]
        p0 = torch.tensor(pcr[0:2], dtype=torch.float32, device=dev)
        span = torch.tensor(pcr[3:5], dtype=torch.float32, device=dev) - p0
        asg = cfg["assigner"]
        enc = coder.encode(boxes)
        G = boxes.shape[0]
        labels_l, bt_l, bw_l, iou_l = [], [], [], []
        npos = torch.zeros((), dtype=torch.long, device=dev)
        for layer in range(n_layers):
            sl = slice(layer * P, (layer + 1) * P)
            pb = pred_boxes[sl]
            iou = torch.where(valid[None, :], iou_3d(pb[:, :7], boxes[:, :7]), 0.0)  # [P, G]
            cost = hungarian_costs(
                torch.sigmoid(heat[sl].float()), (pb[:, :2] - p0) / span,
                (boxes[:, :2] - p0) / span, iou, labels,
                cls_weight=asg["cls_cost"]["weight"], reg_weight=asg["reg_cost"]["weight"],
                iou_weight=asg["iou_cost"]["weight"], alpha=asg["cls_cost"]["alpha"],
                gamma=asg["cls_cost"]["gamma"])  # [G, P]
            assign = auction_assignment(cost, valid, torch.ones(P, dtype=torch.bool, device=dev))
            ok = (assign >= 0) & valid
            pidx = torch.where(ok, assign, P)  # row P takes the unmatched
            lbl = torch.full((P + 1,), ncls, dtype=torch.long, device=dev)
            lbl[pidx] = labels.long()
            bt = enc.new_zeros((P + 1, enc.shape[1]))
            bt[pidx] = enc.to(bt.dtype)
            bw = enc.new_zeros((P + 1, enc.shape[1]))
            bw[pidx] = ok[:, None].to(bw.dtype).expand(-1, enc.shape[1])
            iou_t = enc.new_zeros(P + 1)
            iou_t[pidx] = torch.where(ok, iou[pidx.clamp(max=P - 1), torch.arange(G, device=dev)],
                                      0.0)
            labels_l.append(lbl[:P])
            bt_l.append(bt[:P])
            bw_l.append(bw[:P])
            iou_l.append(iou_t[:P])
            npos = npos + ok.sum()

        # dense heatmap target (transfusion.py:526-573)
        vx, vy = cfg["voxel_size"][0], cfg["voxel_size"][1]
        osf = cfg["out_size_factor"]
        fX, fY = cfg["grid_size"][0] // osf, cfg["grid_size"][1] // osf
        coor_x = (boxes[:, 0] - pcr[0]) / vx / osf
        coor_y = (boxes[:, 1] - pcr[1]) / vy / osf
        wf = boxes[:, 3] / vx / osf
        lf = boxes[:, 4] / vy / osf
        radius = gaussian_radius((lf, wf), cfg["gaussian_overlap"])
        radius = torch.clamp(radius.int(), min=cfg["min_radius"])
        centers = torch.stack([coor_y.int(), coor_x.int()], -1)  # (col, row) of an [X, Y] map
        hm = draw_heatmap_gaussians(torch.zeros((ncls, fX, fY), device=dev), centers, radius,
                                    labels, valid & (wf > 0) & (lf > 0))
        return (torch.cat(labels_l), torch.cat(bt_l), torch.cat(bw_l), npos, torch.cat(iou_l),
                hm)

    def get_bboxes(self, preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Decoded boxes of the last decoder layer: {"bboxes" [B, P, 9],
        "scores", "labels", "mask"}."""
        if self.test_cfg.get("nms_type") is not None:
            raise NotImplementedError("TransFusion NMS (ROADMAP: remaining heads and NMS)")
        P = self.num_proposals
        heat = preds["heatmap"][:, -P:].sigmoid()
        onehot = F.one_hot(preds["query_labels"], self.num_classes).to(heat.dtype)
        score = heat * preds["query_heatmap_score"] * onehot

        def tx(a):
            return a[:, -P:].transpose(1, 2)

        return self.coder.decode(score.transpose(1, 2), tx(preds["rot"]), tx(preds["dim"]),
                                 tx(preds["center"]), tx(preds["height"]),
                                 tx(preds["vel"]) if "vel" in preds else None)
