"""Shared 2D building blocks (NCHW).

Counterpart of ``bevfusion_tpu/models/layers.py`` for what the port's
models use. PyTorch has the JAX package's ``Conv`` (torch-style integer
padding), ``max_pool2d_same`` and ``resize_bilinear`` natively as
``nn.Conv2d``, ``F.max_pool2d`` and ``F.interpolate``; ``Norm``,
``ConvBNAct`` and ``conv_bn_relu`` remain.

Every BatchNorm of the port is ``BatchNorm1d`` / ``BatchNorm2d`` below:
torch's normalisation, with running statistics that move like flax's
(towards the *biased* batch variance; torch's own take the unbiased one).
``Dropout`` and ``DropPath`` draw their masks from an explicit
``torch.Generator`` (``set_dropout_generator``).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm1d", "BatchNorm2d", "Dropout", "DropPath", "set_dropout_generator", "Norm",
           "ConvBNAct", "conv_bn_relu", "resize_bilinear"]


class _FlaxStatsBatchNorm:
    """Training forward of a BatchNorm whose running statistics follow
    flax's ``nn.BatchNorm`` (``bevfusion_tpu/models/layers.py:Norm``):
    ``ra = (1 - momentum) * ra + momentum * batch_stat`` with the biased
    batch variance (torch convention momentum). The output is torch's:
    normalised by the batch mean and biased variance."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, [0, *range(2, x.dim())], correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


class BatchNorm1d(_FlaxStatsBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStatsBatchNorm, nn.BatchNorm2d):
    pass


class _Random(nn.Module):
    """A module that draws random masks in training from ``self.generator``
    (a ``torch.Generator`` on the input's device, set by
    ``set_dropout_generator``); at eval, or at rate 0, the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def _keep(self, x: torch.Tensor, shape) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}({self.rate}) in training draws from an "
                               "explicit generator: call set_dropout_generator(model, g) first")
        u = torch.rand(shape, generator=self.generator, device=x.device, dtype=x.dtype)
        keep = 1.0 - self.rate
        return torch.where(u < keep, x / keep, 0.0)

    def active(self) -> bool:
        return self.training and self.rate > 0.0


class Dropout(_Random):
    """Elementwise dropout (flax ``nn.Dropout``): keep with probability
    1 - rate, scale kept values by 1 / (1 - rate)."""

    def forward(self, x):
        return self._keep(x, x.shape) if self.active() else x


class DropPath(_Random):
    """Stochastic depth (the JAX package's Swin ``DropPath``): one keep
    draw per sample over the leading axis, kept samples scaled by
    1 / (1 - rate)."""

    def forward(self, x):
        return self._keep(x, (x.shape[0],) + (1,) * (x.dim() - 1)) if self.active() else x


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Give every ``Dropout`` / ``DropPath`` of ``model`` ``generator``; they
    draw from it in module order, so a freshly seeded generator repeats a
    training forward's masks."""
    for m in model.modules():
        if isinstance(m, _Random):
            m.generator = generator
    return model


def Norm(norm_type: str, num_features: int, eps: float = 1e-5,
         momentum: float = 0.1) -> nn.BatchNorm2d:
    """BatchNorm2d selected by a reference-style norm type (momentum in the
    torch convention)."""
    if not (norm_type.startswith("BN") or norm_type.startswith("SyncBN")
            or norm_type == "naiveSyncBN"):
        raise NotImplementedError(f"norm type {norm_type!r} (ROADMAP: LN/GN norms)")
    return BatchNorm2d(num_features, eps=eps, momentum=momentum)


class ConvBNAct(nn.Module):
    """conv (no bias: a norm follows) -> BN -> ReLU, the mmcv ConvModule
    contract; children are named ``conv`` and ``bn`` like the reference
    checkpoint's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x):
        return self.bn(self.conv(x)).relu()


def conv_bn_relu(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = False) -> List[nn.Module]:
    """[Conv2d, BatchNorm2d, ReLU] for a reference ``nn.Sequential`` whose
    checkpoint keys are flat indices (DepthLSS's ``dtransform.3.weight``,
    ConvFuser's ``fuser.1.running_mean``); ``bias`` as the reference has it."""
    return [nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=bias),
            BatchNorm2d(out_channels), nn.ReLU()]


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (H', W'). The JAX
    package's ``resize_bilinear`` reproduces torch's ``F.interpolate``
    sampling grid for both ``align_corners`` values, so this is that call."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)
