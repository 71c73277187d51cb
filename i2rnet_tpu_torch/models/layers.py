"""Core building blocks (PyTorch, NCHW).

Port of ``i2rnet_tpu/models/layers.py``. Module and parameter names are the
original PyTorch repo's (``conv1``/``bn1``/``downsample.0``...), so its state
dicts load as they are and ``convert/torch_import.py`` maps them to the JAX
tree. Parameters stay float32; convolutions and linears cast them to the
activation dtype at use, as flax's ``dtype=`` does: the input's dtype, or
``compute_dtype`` where the owning model sets one (the HRFormer, whose stream
may be f32 where its projections compute in bf16). :func:`conv_init_` is the
JAX package's ``conv_init`` (N(0, 0.001), reference ``init_weights``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint
from torch import nn

from i2rnet_tpu_torch.parallel import dist


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, else the input's dtype
    (float32 master weights). ``groups=channels`` makes it depthwise
    (HRFormer's ``dw3x3`` and fusion downsamples, flax ``feature_group_count``)."""

    compute_dtype = None

    def forward(self, x):
        x = x.to(self.compute_dtype or x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``, else the input's dtype
    (float32 master weights)."""

    compute_dtype = None

    def forward(self, x):
        x = x.to(self.compute_dtype or x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Every :class:`Conv2d` and :class:`Linear` under ``module`` computes in
    ``dtype`` (flax ``dtype=`` on each of the model's layers)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype


class LayerNorm(nn.LayerNorm):
    """HRFormer's LayerNorm over the last (channel) axis: eps 1e-6, statistics
    and affine in f32, the result in the input's dtype (flax ``nn.LayerNorm``
    feeding a Dense of that dtype)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


CONV_INIT_STD = 0.001


def conv_init_(weight, generator=None):
    """``conv_init`` of the JAX package: N(0, 0.001) in place."""
    return nn.init.normal_(weight, 0.0, CONV_INIT_STD, generator=generator)


class _Recompute(threading.local):
    """Whether this thread runs a :func:`remat` region again (the backward's
    recomputation, which autograd may run on a thread of its own)."""

    active = False


_RECOMPUTE = _Recompute()


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

    Under a process group of more than one rank (``parallel/dist.py``) it
    is a masked sync-BN: the statistics and the count are those of the valid
    persons of the global batch, every rank's rows, with the gradients
    through the all-reduces (the JAX BN computes the same sums over a batch
    sharded on a mesh); the running statistics then move alike on every
    rank. Every rank must run the same BNs in the same order.

    The model that owns the BNs sets ``person_mask`` on each of them before a
    training forward and clears it after, so the state-dict names stay the
    reference's (``PureMultiInterFormer.forward``). A forward that
    :func:`remat` runs again in the backward moves no running statistic: each
    moves once per training forward, as Flax commits no recomputation's
    ``batch_stats``.
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
        if dist.active():
            mean, var, cnt = self._global_stats(xf)
        elif self.person_mask is None:
            cnt = torch.tensor(float(x.shape[0] * h * w), device=x.device)
            mean = xf.mean((0, 2, 3))
            var = ((xf - mean[:, None, None]) ** 2).mean((0, 2, 3))
        else:
            m = self.person_mask.to(x.device, torch.float32)[:, None, None, None]
            cnt = torch.clamp(m.sum() * (h * w), min=1.0)
            mean = (xf * m).sum((0, 2, 3)) / cnt
            var = (((xf - mean[:, None, None]) ** 2) * m).sum((0, 2, 3)) / cnt
        if _RECOMPUTE.active:
            return mean, var
        with torch.no_grad():
            unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
            self.num_batches_tracked.add_(1)
        return mean, var

    def _global_stats(self, xf):
        """The two-pass statistics over the valid persons of every rank's
        rows: ``sum x m`` and the count ``sum m H W`` in one all-reduce, then
        ``sum (x - mean)^2 m`` in another; gradients pass through both
        (``parallel/dist.py::all_reduce_sum``). A rank without a valid person
        joins both with zeros."""
        h, w = xf.shape[2], xf.shape[3]
        if self.person_mask is None:
            m = None
            local = xf.new_tensor(float(xf.shape[0] * h * w))
        else:
            m = self.person_mask.to(xf.device, torch.float32)[:, None, None, None]
            local = m.sum() * (h * w)
        s1 = (xf if m is None else xf * m).sum((0, 2, 3))
        both = dist.all_reduce_sum(torch.cat([s1, local.reshape(1)]))
        cnt = torch.clamp(both[-1].detach(), min=1.0)
        mean = both[:-1] / cnt
        sq = (xf - mean[:, None, None]) ** 2
        var = dist.all_reduce_sum((sq if m is None else sq * m).sum((0, 2, 3))) / cnt
        return mean, var, cnt


@contextlib.contextmanager
def training_call(model: nn.Module, train: bool, person_valid):
    """The JAX ``train=`` flag for one call: ``model`` runs in training mode
    inside the block (restored after), and with ``train`` every
    :class:`MaskedBatchNorm` under it normalises over the valid persons
    (``person_valid`` ``[B, N]`` flattened as each BN's ``person_mask``)."""
    was_training = model.training
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)] if train else []
    if train != was_training:
        model.train(train)
    for bn in bns:
        bn.person_mask = person_valid.reshape(-1)
    try:
        yield
    finally:
        for bn in bns:
            bn.person_mask = None
        if train != was_training:
            model.train(was_training)


#: ``DEVICE.REMAT`` values (the JAX ``TPU.REMAT``, ``i2rnet_tpu/core/train.py:53``):
#: off (False, None, "none"); each encoder layer and HRFormer block recomputed
#: (True, "layers", inside the model); the whole forward and loss recomputed
#: but the matrix products (``"dots"``), or all of it (``"full"``), at the step
#: (``core/train.py``)
REMAT_VALUES = (False, None, "none", True, "layers", "dots", "full")
#: what ``"dots"`` keeps from the first run: the outputs of products without
#: batch dimensions, as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
#: (no batched product, convolution or hand kernel)
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_remat(remat) -> None:
    """Raise for a ``DEVICE.REMAT`` outside :data:`REMAT_VALUES`."""
    if remat not in REMAT_VALUES:
        raise ValueError(f"DEVICE.REMAT must be one of {REMAT_VALUES}, got {remat!r}")


def remat_layers(remat) -> bool:
    """``DEVICE.REMAT`` checked; whether it recomputes each layer and block."""
    check_remat(remat)
    return remat in (True, "layers")


def save_products_policy(ctx, op, *args, **kwargs):
    """``"dots"``: keep :data:`SAVED_PRODUCTS`' outputs, recompute the rest."""
    if op in SAVED_PRODUCTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _replay(modes, masks):
    """The recomputation's context: the region's modules in the training
    modes, and its BatchNorms with the person masks, of the first run, and no
    running statistic moved; the present state restored after."""
    now_modes = [(m, m.training) for m, _ in modes]
    now_masks = [(bn, bn.person_mask) for bn, _ in masks]
    was = _RECOMPUTE.active
    try:
        for m, training in modes:
            m.training = training
        for bn, mask in masks:
            bn.person_mask = mask
        _RECOMPUTE.active = True
        yield
    finally:
        _RECOMPUTE.active = was
        for m, training in now_modes:
            m.training = training
        for bn, mask in now_masks:
            bn.person_mask = mask


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def remat(module: nn.Module, fn, *args, policy=None):
    """``fn(*args)`` under ``torch.utils.checkpoint``: autograd keeps none of
    the region's activations, and the backward runs ``fn`` again for them.

    Non-reentrant (``use_reentrant=False``), so the gradients reach
    parameters when no input requires one (the step's images, a frozen first
    stage). The recomputation sees every module under ``module`` in the
    training mode, and every :class:`MaskedBatchNorm` with the person mask,
    of the first run, whatever the model's call has reset since, and moves no
    running statistic. ``policy`` (``"dots"``: :func:`save_products_policy`)
    keeps some ops' outputs from the first run. Dropout draws must come from
    generators made in the region from the step's seed (``models/encoder.py``):
    a generator that lives across the region would give the recomputation
    other bits. Without grad mode (a frozen stage) ``fn`` just runs.
    """
    if not torch.is_grad_enabled():
        return fn(*args)
    modes = [(m, m.training) for m in module.modules()]
    masks = [(m, m.person_mask) for m in module.modules() if isinstance(m, MaskedBatchNorm)]

    def contexts():
        if policy is None:
            return contextlib.nullcontext(), _replay(modes, masks)
        first, again = torch_checkpoint.create_selective_checkpoint_contexts(policy)
        return first, _both(_replay(modes, masks), again)

    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


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


def upsample_bilinear(x, size):
    """NCHW bilinear resize to ``size`` (h, w) with half-pixel centres:
    ``jax.image.resize(..., "bilinear")`` for the integer upsampling HRFormer's
    fusion does (antialiasing only acts when downsampling)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def max_pool_3x3_s2(x):
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)
