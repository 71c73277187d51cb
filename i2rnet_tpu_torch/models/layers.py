"""Core building blocks (PyTorch, NCHW).

Port of ``i2rnet_tpu/models/layers.py``. Module and parameter names are the
original PyTorch repo's (``conv1``/``bn1``/``downsample.0``...), so its state
dicts load as they are and ``convert/torch_import.py`` maps them to the JAX
tree. Parameters stay float32; convolutions and linears cast them to the
activation dtype at use, as flax's ``dtype=`` does. :func:`conv_init_` is the
JAX package's ``conv_init`` (N(0, 0.001), reference ``init_weights``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype (float32 master weights)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype (float32 master weights)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


CONV_INIT_STD = 0.001


def conv_init_(weight, generator=None):
    """``conv_init`` of the JAX package: N(0, 0.001) in place."""
    return nn.init.normal_(weight, 0.0, CONV_INIT_STD, generator=generator)


class MaskedBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW whose training statistics count valid persons only
    (``layers.py:34-85``).

    Eval: the running statistics. Training: the batch mean and the biased
    variance over the samples whose ``person_mask`` entry is True (a ``[N]``
    bool tensor over the batch axis, broadcast over H and W; all samples when
    it is None), the count ``max(sum(mask) * H * W, 1)``; the running
    statistics move with torch's momentum 0.1, the variance unbiased by
    ``cnt / max(cnt - 1, 1)``. Either way the statistics fold into one
    multiply-add in the activation dtype with the [C]-sized math in f32, and
    in training the gradients flow through the batch statistics.

    The model that owns the BNs sets ``person_mask`` on each of them before a
    training forward and clears it after, so the state-dict names stay the
    reference's (``PureMultiInterFormer.forward``).
    """

    person_mask = None

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self._batch_stats(x)
        k = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * k
        return x * k.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]

    def _batch_stats(self, x):
        xf = x.float()
        h, w = x.shape[2], x.shape[3]
        if self.person_mask is None:
            cnt = torch.tensor(float(x.shape[0] * h * w), device=x.device)
            mean = xf.mean((0, 2, 3))
            var = ((xf - mean[:, None, None]) ** 2).mean((0, 2, 3))
        else:
            m = self.person_mask.to(x.device, torch.float32)[:, None, None, None]
            cnt = torch.clamp(m.sum() * (h * w), min=1.0)
            mean = (xf * m).sum((0, 2, 3)) / cnt
            var = (((xf - mean[:, None, None]) ** 2) * m).sum((0, 2, 3)) / cnt
        with torch.no_grad():
            unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
            self.num_batches_tracked.add_(1)
        return mean, var


class ConvBN(nn.Sequential):
    """Conv (no bias, padding k//2) + BN, optional ReLU; children ``0``/``1``
    as the reference's ``nn.Sequential(conv, bn[, relu])``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True):
        mods = [Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False),
                MaskedBatchNorm(cout)]
        if relu:
            mods.append(nn.ReLU())
        super().__init__(*mods)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block, expansion 1 (reference pureMulti :37-66)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = MaskedBatchNorm(planes)
        self.downsample = (ConvBN(cin, planes * self.expansion, 1, stride, relu=False)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 residual block, expansion 4 (reference pureMulti :69-107)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = MaskedBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = MaskedBatchNorm(planes * self.expansion)
        self.downsample = (ConvBN(cin, planes * self.expansion, 1, stride, relu=False)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class DeconvBlock(nn.Sequential):
    """``ConvTranspose2d(k=4, s=2, p=1)`` + BN + ReLU (reference
    ``_make_deconv_layer``, ``interformer_pureMulti.py:648-673``): exact 2x
    upsampling. Children ``0``/``1`` as the reference's ``deconv_layers``."""

    def __init__(self, cin: int, cout: int, kernel: int = 4, bias: bool = False):
        if kernel != 4:
            raise NotImplementedError(f"deconv kernel {kernel}: only the recipe's 4 is ported")
        super().__init__(nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=bias),
                         MaskedBatchNorm(cout), nn.ReLU())

    def forward(self, x):
        deconv, bn, relu = self
        b = None if deconv.bias is None else deconv.bias.to(x.dtype)
        x = F.conv_transpose2d(x, deconv.weight.to(x.dtype), b, 2, 1)
        return relu(bn(x))


def upsample_nearest(x, factor: int):
    """Exact torch ``nn.Upsample(scale_factor=factor, mode='nearest')``."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def max_pool_3x3_s2(x):
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)
