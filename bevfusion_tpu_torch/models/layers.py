"""Shared 2D building blocks (NCHW).

Counterpart of ``bevfusion_tpu/models/layers.py`` for what the port's
models use. PyTorch has the JAX package's ``Conv`` (torch-style integer
padding), ``max_pool2d_same`` and ``resize_bilinear`` natively as
``nn.Conv2d``, ``F.max_pool2d`` and ``F.interpolate``; ``Norm``,
``ConvBNAct``, ``conv_bn_relu`` and ``BasicBlock`` remain. ``Norm`` builds
BatchNorm, or flax's ``LayerNorm`` / ``GroupNorm`` over the channel axis
(``ChannelLayerNorm``, ``GroupNorm``).

Every BatchNorm of the port is ``BatchNorm1d`` / ``BatchNorm2d`` below:
torch's normalisation, with running statistics that move like flax's
(towards the *biased* batch variance; torch's own take the unbiased one).
``Dropout`` and ``DropPath`` draw their masks from an explicit
``torch.Generator`` (``set_dropout_generator``). ``at_least_fp32`` is the
cast of the losses and the softmaxes that the port computes in fp32.

At bf16 (``runtime/precision.py``) a BatchNorm or ``LayerNorm`` takes its
statistics in fp32 and returns its input's dtype, as flax's norms under
``dtype=bfloat16``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel

__all__ = ["BatchNorm1d", "BatchNorm2d", "batch_norm_train", "LayerNorm", "ChannelLayerNorm",
           "GroupNorm", "Dropout", "DropPath",
           "set_dropout_generator", "Norm", "ConvBNAct", "conv_bn_relu", "BasicBlock",
           "resize_bilinear", "at_least_fp32"]


class _FlaxStatsBatchNorm:
    """Training forward of a BatchNorm whose running statistics follow
    flax's ``nn.BatchNorm`` (``bevfusion_tpu/models/layers.py:Norm``):
    ``ra = (1 - momentum) * ra + momentum * batch_stat`` with the biased
    batch variance (torch convention momentum). The output is torch's:
    normalised by the batch mean and biased variance. Under data
    parallelism (``parallel.active()``) the moments are the global batch's,
    taken in two passes over every rank (``parallel.masked_moments``: the
    JAX package's GSPMD BatchNorm, the reference's NaiveSyncBatchNorm), in
    fp32 or wider, and the running statistics move alike on every rank."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if parallel.active():
            return self._global(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(at_least_fp32(x), [0, *range(2, x.dim())], correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y

    def _global(self, x):
        return batch_norm_train(self, x, None, [0, *range(2, x.dim())]).to(x.dtype)


def batch_norm_train(bn, x: torch.Tensor, m: Optional[torch.Tensor], dims) -> torch.Tensor:
    """The training forward of BatchNorm ``bn`` on ``x``: its entries where
    ``m`` is 1 (0/1, broadcastable; None: every entry) normalised by their
    two-pass moments over ``dims`` (``parallel.masked_moments``: over every
    rank's batch under data parallelism), in fp32 or wider; ``bn``'s running
    statistics moved by its momentum. Returns the result in fp32 (or wider),
    inactive entries not zeroed."""
    xf = at_least_fp32(x)
    mean, var = parallel.masked_moments(xf, None if m is None else m.to(xf.dtype), dims)
    with torch.no_grad():
        bn.running_mean.lerp_(mean.flatten().to(bn.running_mean.dtype), bn.momentum)
        bn.running_var.lerp_(var.flatten().to(bn.running_var.dtype), bn.momentum)
        bn.num_batches_tracked += 1
    shape = mean.shape
    return (xf - mean) * torch.rsqrt(var + bn.eps) * bn.weight.view(shape) + bn.bias.view(shape)


class BatchNorm1d(_FlaxStatsBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStatsBatchNorm, nn.BatchNorm2d):
    pass


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its statistics and affine in fp32 (or wider)
    and the result in the input's dtype, as flax's ``LayerNorm`` (CUDA
    autocast would return fp32 from a bf16 input)."""

    def forward(self, x):
        return F.layer_norm(at_least_fp32(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class ChannelLayerNorm(LayerNorm):
    """flax's ``LayerNorm`` over the channel axis (dim 1) of ``[N, C, ...]``:
    each position normalised over its C values (the JAX package's ``Norm``
    "LN" on channels-last maps)."""

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class GroupNorm(nn.GroupNorm):
    """flax's ``GroupNorm`` (32 groups by default) over ``[N, C, ...]``: each
    sample's group of C / 32 consecutive channels normalised over those
    channels and every position; statistics and affine in fp32 (or wider),
    the result in the input's dtype."""

    def __init__(self, num_channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__(num_groups, num_channels, eps)

    def forward(self, x):
        return F.group_norm(at_least_fp32(x), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


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
        # drawn in fp32 (float64 for a float64 model) at any compute dtype: a
        # bf16 run keeps an fp32 run's masks
        u = torch.rand(shape, generator=self.generator, device=x.device,
                       dtype=torch.promote_types(x.dtype, torch.float32))
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
         momentum: float = 0.1, dims: int = 2) -> nn.Module:
    """The norm a reference-style norm type names (momentum in the torch
    convention), over the channel axis (dim 1): BatchNorm2d (``dims=1``:
    BatchNorm1d) for BN / SyncBN / naiveSyncBN, ``ChannelLayerNorm`` for LN,
    ``GroupNorm`` (32 groups, flax's default) for GN, as the JAX ``Norm``.
    flax computes a LayerNorm's and a GroupNorm's variance as E[x^2] -
    E[x]^2 in fp32 ("fast variance"), torch as E[(x - mean)^2]: the two
    agree to rounding unless the mean dwarfs the spread."""
    if norm_type.startswith("BN") or norm_type.startswith("SyncBN") \
            or norm_type == "naiveSyncBN":
        return (BatchNorm1d if dims == 1 else BatchNorm2d)(num_features, eps=eps,
                                                           momentum=momentum)
    if norm_type == "LN":
        return ChannelLayerNorm(num_features, eps=eps)
    if norm_type == "GN":
        return GroupNorm(num_features, eps=eps)
    raise ValueError(f"unsupported norm type {norm_type}")


class ConvBNAct(nn.Module):
    """conv (no bias: a norm follows) -> BN -> ReLU (``relu=False``: no
    activation), the mmcv ConvModule contract; children are named ``conv``
    and ``bn`` like the reference checkpoint's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(out_channels)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return y.relu() if self.relu else y


def conv_bn_relu(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = False) -> List[nn.Module]:
    """[Conv2d, BatchNorm2d, ReLU] for a reference ``nn.Sequential`` whose
    checkpoint keys are flat indices (DepthLSS's ``dtransform.3.weight``,
    ConvFuser's ``fuser.1.running_mean``); ``bias`` as the reference has it."""
    return [nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=bias),
            BatchNorm2d(out_channels), nn.ReLU()]


class BasicBlock(nn.Module):
    """mmcv's ResNet ``BasicBlock``: 3x3 conv (stride) -> BN -> ReLU -> 3x3
    conv -> BN, plus the shortcut, then ReLU. The shortcut is ``downsample``
    (1x1 conv with the stride, no bias -> BN) where the stride or the
    width changes, else the input. Names ``conv1``, ``bn1``, ``conv2``,
    ``bn2``, ``downsample.{0,1}`` as in the reference checkpoint."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(out_channels)
        self.downsample = (nn.Sequential(nn.Conv2d(in_channels, out_channels, 1, stride, bias=False),
                                         BatchNorm2d(out_channels))
                           if stride != 1 or in_channels != out_channels else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x)).relu()
        return (self.bn2(self.conv2(out)) + identity).relu()


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (H', W'). The JAX
    package's ``resize_bilinear`` reproduces torch's ``F.interpolate``
    sampling grid for both ``align_corners`` values, so this is that call.
    A bf16 ``x`` is resized in fp32 and rounded once, as the JAX package
    computes it (its fp32 weights promote) and as CUDA's autocast runs
    ``upsample_bilinear2d``; explicit, so the CPU computes the same and a
    ``torch.export`` trace records the dtypes that run."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(at_least_fp32(x), size=tuple(size), mode="bilinear",
                         align_corners=align_corners).to(x.dtype)


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is if wider: a model made float64 (the CPU
    parity tests' reference runs) stays float64 through its losses."""
    return x if x.dtype == torch.float64 else x.float()
