"""Swin Transformer backbone (tokens [B, L, C]; NCHW in and out).

Counterpart of ``bevfusion_tpu/models/swin.py`` (Swin-T as the reference
configures it: configs/nuscenes/det/.../swint/default.yaml), with mmdet's
module names so a released checkpoint loads strictly:
``patch_embed.{projection,norm}``, ``stages.N.blocks.M.{norm1,
attn.w_msa.{qkv,proj,relative_position_bias_table,relative_position_index},
norm2,ffn.layers.0.0,ffn.layers.1}``, ``stages.N.downsample.{norm,reduction}``
and ``norm{i}`` for each emitted scale. In training, DropPath (rate
linear in the block index up to ``drop_path_rate``) and dropout act where
the JAX package's do, drawing from an explicit generator
(``models/layers.py:set_dropout_generator``).

What follows the JAX package rather than mmdet:
- every LayerNorm uses flax's epsilon 1e-6 (torch and mmdet use 1e-5);
- a block pads its tokens to a multiple of the window *after* ``norm1``
  and does not mask the zero tokens: they take part in attention;
- the shifted-window mask is -100 between pre-shift regions, built on the
  padded grid;
- the patch embedding is a VALID conv (no padding of the image);
- PatchMerging concatenates ``x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
  x[1::2, 1::2]`` in that order.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONES
from ..runtime.precision import fp32_region
from .heads.transformer import LAYER_NORM_EPS
from .layers import DropPath, Dropout, LayerNorm, at_least_fp32

__all__ = ["SwinTransformer", "relative_position_index"]


def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the relative-position bias table (the
    JAX package's ``_relative_position_index``)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA mask [num_windows, ws*ws, ws*ws] on the padded H x W grid:
    -100 where two tokens come from different pre-shift regions."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    wins = wins.reshape(-1, ws * ws)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _cached_mask(H: int, W: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_shift_attn_mask(H, W, ws, shift)).to(device)


def _mask_on(H: int, W: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """The shifted windows' mask on ``device``, cached; under ``torch.export``
    made afresh (a constant of that trace: a cached one would be the fake
    tensor of another trace)."""
    if torch.compiler.is_exporting():
        return torch.from_numpy(_shift_attn_mask(H, W, ws, shift)).to(device)
    return _cached_mask(H, W, ws, shift, device)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return LayerNorm(dim, eps=LAYER_NORM_EPS)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nH * nW, ws*ws, C]."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """[B * nH * nW, ws*ws, C] -> [B, H, W, C]."""
    C = wins.shape[-1]
    x = wins.view(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


class WindowMSA(nn.Module):
    """Multi-head self-attention inside each window, with the learned
    relative-position bias; the logits, bias, mask and softmax in fp32 at
    any compute dtype (the JAX package's ``preferred_element_type``), the
    weights then in the values' dtype."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = Dropout(attn_drop), Dropout(proj_drop)
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        # persistent: a released checkpoint carries this constant
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window_size)).long())
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [Bn, N, C]; mask [nW, N, N] (Bn a multiple of nW) or None."""
        Bn, N, C = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).view(Bn, N, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        with fp32_region(x):
            attn = (at_least_fp32(q) * self.scale) @ at_least_fp32(k).transpose(-2, -1)
            bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
            attn = attn + bias.view(N, N, nh).permute(2, 0, 1)[None]
            if mask is not None:
                nW = mask.shape[0]
                attn = attn.view(Bn // nW, nW, nh, N, N) + mask[None, :, None]
                attn = attn.view(Bn, nh, N, N)
            attn = attn.softmax(-1).to(v.dtype)
        out = self.attn_drop(attn) @ v
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(Bn, N, C)))


class ShiftWindowMSA(nn.Module):
    """Pad to whole windows, cyclic shift, window attention, and back."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.w_msa = WindowMSA(dim, num_heads, window_size, qkv_bias, qk_scale, attn_drop,
                               proj_drop)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        ws, s = self.window_size, self.shift
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x.view(B, H, W, C), (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), (1, 2))
            mask = _mask_on(Hp, Wp, ws, s, x.device)
        x = _window_reverse(self.w_msa(_window_partition(x, ws), mask), ws, Hp, Wp)
        if s > 0:
            x = torch.roll(x, (s, s), (1, 2))
        return x[:, :H, :W].reshape(B, L, C)


class FFN(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                                  Dropout(drop)),
                                    nn.Linear(hidden, dim), Dropout(drop))

    def forward(self, x):
        return self.layers(x)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, shift, qkv_bias, qk_scale,
                                   attn_drop, drop)
        self.norm2 = _layer_norm(dim)
        self.ffn = FFN(dim, int(dim * mlp_ratio), drop)
        self.drop_path1, self.drop_path2 = DropPath(drop_path), DropPath(drop_path)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x), H, W))
        return x + self.drop_path2(self.ffn(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 neighbour concat -> LayerNorm -> Linear(4C -> 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = _layer_norm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int):
        B, L, C = x.shape
        x = F.pad(x.view(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        Ho, Wo = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.reshape(B, Ho * Wo, 4 * C))), Ho, Wo


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)
        if downsample is not None:
            self.downsample = downsample


class PatchEmbed(nn.Module):
    def __init__(self, embed_dims: int, patch_size: int, patch_norm: bool):
        super().__init__()
        self.projection = nn.Conv2d(3, embed_dims, patch_size, patch_size)
        self.norm = _layer_norm(embed_dims) if patch_norm else None


@BACKBONES.register
class SwinTransformer(nn.Module):
    """[B, 3, H, W] -> tuple of NCHW maps at ``out_indices``."""

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.2, patch_size: int = 4, patch_norm: bool = True,
                 out_indices: Sequence[int] = (1, 2, 3), with_cp: bool = False,
                 convert_weights: bool = True, init_cfg: Optional[dict] = None,
                 pretrain_img_size: int = 224, use_abs_pos_embed: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dims, patch_size, patch_norm)
        self.drop_after_pos = Dropout(drop_rate)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        stages, dims = [], [embed_dims * 2 ** i for i in range(len(depths))]
        for si, depth in enumerate(depths):
            blocks = [SwinBlock(dims[si], num_heads[si], window_size,
                                0 if bi % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                                qk_scale, drop_rate, attn_drop_rate,
                                float(dpr[sum(depths[:si]) + bi])) for bi in range(depth)]
            stages.append(SwinStage(blocks, PatchMerging(dims[si])
                                    if si < len(depths) - 1 else None))
        self.stages = nn.Sequential(*stages)
        for i in self.out_indices:
            self.add_module(f"norm{i}", _layer_norm(dims[i]))

    def forward(self, x: torch.Tensor):
        x = self.patch_embed.projection(x)
        B, C, H, W = x.shape
        x = x.flatten(2).transpose(1, 2)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        x = self.drop_after_pos(x)
        outs = []
        for si, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x, H, W)
            if si in self.out_indices:
                y = getattr(self, f"norm{si}")(x)
                outs.append(y.view(B, H, W, -1).permute(0, 3, 1, 2).contiguous())
            if hasattr(stage, "downsample"):
                x, H, W = stage.downsample(x, H, W)
        return tuple(outs)
