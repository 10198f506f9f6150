"""Transformer pieces of the TransFusion head.

Counterpart of ``bevfusion_tpu/models/heads/transformer.py`` (reference
mmdet3d/models/utils/transformer.py: PositionEmbeddingLearned :14-30,
post-norm TransformerDecoderLayer :33-112, the conv FFN prediction head
:496-575). Queries are ``[B, P, C]`` as in the JAX package; the conv
branches take ``[B, C, P]``. Parameter names follow the reference
checkpoint, including torch MultiheadAttention's packed
``in_proj_weight`` (q, k, v rows).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...runtime.precision import fp32_region
from ..layers import BatchNorm1d, Dropout, LayerNorm, at_least_fp32

# flax LayerNorm's default epsilon, which the JAX package's decoder uses
LAYER_NORM_EPS = 1e-6


class PositionEmbeddingLearned(nn.Module):
    """1x1-conv MLP over positions: [B, P, in_ch] -> [B, P, C]."""

    def __init__(self, in_channels: int, num_pos_feats: int = 128, bn_momentum: float = 0.1):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            nn.Conv1d(in_channels, num_pos_feats, 1),
            BatchNorm1d(num_pos_feats, momentum=bn_momentum), nn.ReLU(),
            nn.Conv1d(num_pos_feats, num_pos_feats, 1))

    def forward(self, xyz):
        return self.position_embedding_head(xyz.transpose(1, 2)).transpose(1, 2)


class MultiheadAttention(nn.Module):
    """torch MultiheadAttention math on batch-first [B, L, C], written out
    (q scaled by head_dim**-0.5, softmax over keys), with dropout on the
    attention weights in training. The logits and softmax are fp32 at any
    compute dtype (JAX transformer.py:58), the weights then in the values'
    dtype."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v):
        B, Lq, C = q.shape
        H = self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qh = F.linear(q, wq, bq).view(B, Lq, H, -1).transpose(1, 2)
        kh = F.linear(k, wk, bk).view(B, k.shape[1], H, -1).transpose(1, 2)
        vh = F.linear(v, wv, bv).view(B, v.shape[1], H, -1).transpose(1, 2)
        with fp32_region(q):
            qf, kf = at_least_fp32(qh), at_least_fp32(kh)
            attn = torch.softmax((qf * qh.shape[-1] ** -0.5) @ kf.transpose(-1, -2), dim=-1)
            attn = attn.to(vh.dtype)
        out = (self.attn_drop(attn) @ vh).transpose(1, 2).reshape(B, Lq, C)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention to the BEV
    tokens and an FFN, with learned position embeddings added to q and k;
    in training, dropout at the JAX package's places (attention weights,
    each residual branch, the FFN's hidden layer)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048,
                 activation: str = "relu", bn_momentum: float = 0.1, dropout: float = 0.0):
        super().__init__()
        self.act = {"relu": F.relu, "gelu": F.gelu}[activation]
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.drop = nn.ModuleList(Dropout(dropout) for _ in range(4))
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1, self.norm2, self.norm3 = (
            LayerNorm(d_model, eps=LAYER_NORM_EPS) for _ in range(3))
        self.self_posembed = PositionEmbeddingLearned(2, d_model, bn_momentum)
        self.cross_posembed = PositionEmbeddingLearned(2, d_model, bn_momentum)

    def forward(self, query, key, query_pos, key_pos):
        """query [B, P, C]; key [B, K, C]; *_pos [B, P or K, 2]."""
        qe = self.self_posembed(query_pos)
        ke = self.cross_posembed(key_pos)
        q = query + qe
        query = self.norm1(query + self.drop[0](self.self_attn(q, q, q)))
        query = self.norm2(query + self.drop[1](self.multihead_attn(query + qe, key + ke,
                                                                    key + ke)))
        y = self.linear2(self.drop[2](self.act(self.linear1(query))))
        return self.norm3(query + self.drop[3](y))


class FFNHead(nn.Module):
    """Prediction branches over queries [B, C, P]: per branch
    (num_conv - 1) x [Conv1d + BN + ReLU] + a final Conv1d with bias."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, bn_momentum: float = 0.1):
        super().__init__()
        for name, (classes, num_conv) in heads.items():
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers += [nn.Conv1d(c, head_conv, 1),
                           BatchNorm1d(head_conv, momentum=bn_momentum), nn.ReLU()]
                c = head_conv
            layers.append(nn.Conv1d(c, classes, 1))
            if name == "heatmap":
                nn.init.constant_(layers[-1].bias, -2.19)  # the reference's prior
            self.add_module(name, nn.Sequential(*layers))

    def forward(self, x):
        """x [B, C, P] -> {branch: [B, P, classes]}."""
        return {name: branch(x).transpose(1, 2) for name, branch in self.named_children()}
