"""BEV fusers (NCHW).

Counterparts of ``bevfusion_tpu/models/fusers.py``:

- ``ConvFuser`` (reference mmdet3d/models/fusers/conv.py:12-23): concat in
  (camera, lidar, radar) order, 3x3 conv without bias, BN, ReLU. The
  module is the reference's ``nn.Sequential``, so its keys are
  ``fuser.0.weight``, ``fuser.1.*``.
- ``AddFuser`` (reference fusers/add.py:13-40): each sensor's map through
  its own 3x3 conv-BN-ReLU (``transforms.{k}.{0,1}``, the reference's
  ``nn.ModuleList`` of ``nn.Sequential``), then their mean; in training one
  whole sensor, drawn uniformly, is dropped with probability ``dropout``
  and the mean is over the rest.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..registry import FUSERS
from .layers import _Random, conv_bn_relu


@FUSERS.register
class ConvFuser(nn.Sequential):
    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__(*conv_bn_relu(sum(in_channels), out_channels, 3, 1, 1))

    def forward(self, inputs):
        return super().forward(torch.cat(list(inputs), dim=1))


@FUSERS.register
class AddFuser(_Random):
    """The sensor drop draws two uniforms from the module's explicit
    ``torch.Generator`` (``layers.set_dropout_generator``, as every dropout
    of the port): the first below ``dropout`` drops, the second picks the
    sensor. The JAX package draws from its ``dropout`` rng: the same rule,
    other bits."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, dropout: float = 0.0):
        super().__init__(dropout)
        self.transforms = nn.ModuleList(
            nn.Sequential(*conv_bn_relu(c, out_channels, 3, 1, 1)) for c in in_channels)

    def weights(self, n: int, device) -> torch.Tensor:
        """Each sensor's weight [n]: ones, and in training with probability
        ``dropout`` (and n > 1) a zero at one sensor drawn uniformly."""
        w = torch.ones(n, device=device)
        if self.active() and n > 1:
            if self.generator is None:
                raise RuntimeError("AddFuser in training draws from an explicit generator: "
                                   "call set_dropout_generator(model, g) first")
            u = torch.rand(2, generator=self.generator, device=self.generator.device)
            if float(u[0]) < self.rate:
                w[min(int(float(u[1]) * n), n - 1)] = 0.0
        return w

    def forward(self, inputs):
        feats = [t(x) for t, x in zip(self.transforms, inputs)]
        w = self.weights(len(feats), feats[0].device)
        return sum(wk * f for wk, f in zip(w, feats)) / w.sum()
