"""TransFusion detection head, eval path (NCHW).

Counterpart of ``TransFusionHead.__call__`` and ``get_bboxes`` in
``bevfusion_tpu/models/heads/transfusion.py`` (reference
mmdet3d/models/heads/bbox/transfusion.py): dense class heatmap ->
max-pool local-max filter (nuScenes classes 8/9 exempt, :248-256) ->
top ``num_proposals`` queries over classes x cells -> transformer decoder
over the flattened BEV tokens -> FFN prediction branches -> decode.

The top-k is a stable descending sort, so equal scores are taken in
index order as ``jax.lax.top_k`` takes them. Eval only: the loss,
target assignment and NMS (``nms_type`` set) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.coders import TransFusionBBoxCoder
from ...registry import HEADS
from ..layers import ConvBNAct
from .transformer import FFNHead, TransformerDecoderLayer


@HEADS.register
class TransFusionHead(nn.Module):
    def __init__(self, num_proposals: int = 128, auxiliary: bool = True,
                 in_channels: int = 384, hidden_channel: int = 128, num_classes: int = 4,
                 num_decoder_layers: int = 3, num_heads: int = 8, nms_kernel_size: int = 1,
                 ffn_channel: int = 256, dropout: float = 0.1, bn_momentum: float = 0.1,
                 activation: str = "relu", common_heads: Optional[dict] = None,
                 num_heatmap_convs: int = 2, test_cfg: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None, **training_cfg):
        """``training_cfg`` takes the config's training-only keys
        (train_cfg, loss_*), unused until the loss is ported; ``dropout``
        is inactive at eval."""
        super().__init__()
        self.num_proposals = num_proposals
        self.auxiliary = auxiliary
        self.num_classes = num_classes
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
                                    bn_momentum) for _ in range(num_decoder_layers))
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

        heatmap = dense_heatmap.detach().sigmoid()
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

        top = torch.sort(heatmap.reshape(B, -1), dim=1, descending=True,
                         stable=True).indices[:, :P]
        top_cls = top // (H * W)
        top_idx = top % (H * W)
        query_feat = flat.gather(1, top_idx[..., None].expand(-1, -1, flat.shape[-1]))
        onehot = F.one_hot(top_cls, ncls).to(feats.dtype).transpose(1, 2)
        query_feat = query_feat + self.class_encoding(onehot).transpose(1, 2)

        query_pos = torch.stack([top_idx // W, top_idx % W], -1).to(feats.dtype) + 0.5
        gx, gy = torch.meshgrid(torch.arange(H, device=feats.device),
                                torch.arange(W, device=feats.device), indexing="ij")
        bev_pos = (torch.stack([gx, gy], -1).reshape(1, H * W, 2).to(feats.dtype) + 0.5
                   ).expand(B, -1, -1)

        layers = []
        for decoder, ffn in zip(self.decoder, self.prediction_heads):
            query_feat = decoder(query_feat, flat, query_pos, bev_pos)
            res = ffn(query_feat.transpose(1, 2))
            res["center"] = res["center"] + query_pos
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
