"""VoVNet (V2, with eSE) camera backbone (NCHW).

Counterpart of ``bevfusion_tpu/models/vovnet.py`` (reference
mmdet3d/models/backbones/vovnet.py): a stem of three 3x3 conv-BN-ReLU
(strides 2, 1, 2), then four stages of one-shot-aggregation (OSA) modules
-- ``layer_per_block`` 3x3 convs whose outputs are concatenated with the
block's input into a 1x1 "concat" conv, eSE channel attention (a 1x1 conv
of the spatial mean through a hard sigmoid) on a stage's last block, the
input added back on every block after the first -- with a 3x3 / 2
ceil-mode max pool before every stage but the first.

Module names follow the JAX package's (``stem0``, ``OSA2_1.conv0``,
``OSA2_1.concat``, ``OSA2_1.ese.fc``): no released checkpoint was at hand to
check mmdet3d's keys against (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import BACKBONES
from .layers import ConvBNAct

__all__ = ["VoVNet", "OSAModule", "eSEModule", "STAGE_SPECS"]

STAGE_SPECS = {
    "V-19-slim-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(64, 80, 96, 112),
                          stage_out_ch=(112, 256, 384, 512), layer_per_block=3,
                          block_per_stage=(1, 1, 1, 1), eSE=True, dw=False),
    "V-19-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=3,
                     block_per_stage=(1, 1, 1, 1), eSE=True, dw=False),
    "V-39-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 2, 2), eSE=True, dw=False),
    "V-57-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 1, 4, 3), eSE=True, dw=False),
    "V-99-eSE": dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                     stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
                     block_per_stage=(1, 3, 9, 3), eSE=True, dw=False),
}


class eSEModule(nn.Module):
    """x * hsigmoid(fc(mean over H, W)), hsigmoid = clip(g + 3, 0, 6) / 6."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        g = self.fc(x.mean((2, 3), keepdim=True))
        return x * ((g + 3.0).clamp(0.0, 6.0) / 6.0).to(x.dtype)


class OSAModule(nn.Module):
    def __init__(self, in_channels: int, stage_ch: int, concat_ch: int, layer_per_block: int,
                 use_ese: bool = True, identity: bool = False):
        super().__init__()
        c = in_channels
        for i in range(layer_per_block):
            self.add_module(f"conv{i}", ConvBNAct(c, stage_ch, 3, 1, 1))
            c = stage_ch
        self.layer_per_block = layer_per_block
        self.concat = ConvBNAct(in_channels + layer_per_block * stage_ch, concat_ch, 1)
        self.ese = eSEModule(concat_ch) if use_ese else None
        self.identity = identity

    def forward(self, x):
        outs, y = [x], x
        for i in range(self.layer_per_block):
            y = getattr(self, f"conv{i}")(y)
            outs.append(y)
        y = self.concat(torch.cat(outs, 1))
        if self.ese is not None:
            y = self.ese(y)
        return y + x if self.identity else y


@BACKBONES.register
class VoVNet(nn.Module):
    """Returns the outputs of the stages named in ``out_features``
    (``stage2`` .. ``stage5``). ``norm_eval``, ``frozen_stages`` and
    ``init_cfg`` are accepted and, as in the JAX package, not read."""

    def __init__(self, spec_name: str = "V-99-eSE",
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4", "stage5"),
                 norm_eval: bool = False, frozen_stages: int = -1,
                 init_cfg: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        spec = STAGE_SPECS[spec_name]
        s1, s2, s3 = spec["stem"]
        self.stem0 = ConvBNAct(in_channels, s1, 3, 2, 1)
        self.stem1 = ConvBNAct(s1, s2, 3, 1, 1)
        self.stem2 = ConvBNAct(s2, s3, 3, 2, 1)
        self.out_features = list(out_features)
        self.stages = []  # per stage: the names of its OSA modules
        c = s3
        for idx in range(4):
            names, n_blocks = [], spec["block_per_stage"][idx]
            for b in range(n_blocks):
                name = f"OSA{idx + 2}_{b + 1}"
                self.add_module(name, OSAModule(
                    c, spec["stage_conv_ch"][idx], spec["stage_out_ch"][idx],
                    spec["layer_per_block"], use_ese=spec["eSE"] and b == n_blocks - 1,
                    identity=b > 0))
                c = spec["stage_out_ch"][idx]
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        x = self.stem2(self.stem1(self.stem0(x)))
        outs = []
        for idx, names in enumerate(self.stages):
            if idx > 0:  # ceil-mode 3x3 / 2 pool: the JAX package pads right and bottom by 1
                x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
            for name in names:
                x = getattr(self, name)(x)
            if f"stage{idx + 2}" in self.out_features:
                outs.append(x)
        return tuple(outs)
