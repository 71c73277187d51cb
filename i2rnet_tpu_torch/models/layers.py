"""Core building blocks (PyTorch, NCHW), eval path.

Port of ``i2rnet_tpu/models/layers.py``. Module and parameter names are the
original PyTorch repo's (``conv1``/``bn1``/``downsample.0``...), so its state
dicts load as they are and ``convert/torch_import.py`` maps them to the JAX
tree. Parameters stay float32; convolutions and linears cast them to the
activation dtype at use, as flax's ``dtype=`` does.
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


class MaskedBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW, eval mode: running statistics folded into one
    multiply-add in the activation dtype (the [C]-sized math stays f32), as
    ``layers.py:82-85`` does. The masked batch statistics of training are not
    ported yet (ROADMAP queue 1, item 1)."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm training statistics are not ported (ROADMAP queue 1, item 1)")
        k = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * k
        return x * k.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


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
