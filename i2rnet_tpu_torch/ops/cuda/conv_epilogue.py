"""The conv unit's epilogue (eval): ``out = act(y + bias (+ residual))``.

Replaces no Pallas kernel: on the TPU XLA fused the BatchNorm, the residual
add and the ReLU into each convolution's epilogue. The eval path folds the
BatchNorm into the convolution's weights (``models/layers.py::fold_bn``) and
finishes the unit with this one pass; the kernel is ``csrc/conv_epilogue.cu``.
:func:`conv_epilogue_torch` is its plain PyTorch version, with the same
numerics: the sum in f32 (``y + bias``, then the residual), the ReLU, one
rounding to ``y``'s dtype.

``y`` and ``residual`` are ``[N, C, H, W]`` in channels-last memory (the
trunk's layout); ``bias`` is the f32 ``[C]`` folded BatchNorm bias. The output
has ``y``'s dtype and layout.
"""

from __future__ import annotations

import torch

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: bytes a thread loads at once, at most (one 16-byte vector)
VECTOR_BYTES = 16
#: widest C the kernel takes (``kEpiMaxC``: the biases in 48 KB of shared memory)
MAX_C = 12288


def conv_epilogue_torch(y, bias, residual=None, relu: bool = False):
    """Plain PyTorch epilogue, into a tensor laid out as ``y``."""
    z = y.float() + bias.float()[:, None, None]
    if residual is not None:
        z = z + residual.float()
    if relu:
        z = torch.relu(z)
    return torch.empty_like(y).copy_(z)


def vector_width(c: int, itemsize: int, *tensors) -> int:
    """Elements a thread loads at once: the largest power of two that fits
    :data:`VECTOR_BYTES`, divides ``c`` and keeps every tensor's start
    aligned to a whole vector."""
    v = VECTOR_BYTES // itemsize
    while v > 1 and (c % v or any(t.data_ptr() % (v * itemsize) for t in tensors)):
        v //= 2
    return v


def conv_epilogue_fused(y, bias, residual=None, relu: bool = False):
    """The epilogue through the CUDA kernel.

    CPU tensors take :func:`conv_epilogue_torch`; CUDA tensors launch the
    kernel or raise. ``y`` (and ``residual``, of its shape and dtype) must be
    channels-last contiguous, float32 or bfloat16; ``bias`` f32 ``[C]``.
    """
    if y.device.type == "cpu":
        return conv_epilogue_torch(y, bias, residual, relu)
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue_fused: unsupported device {y.device}")
    if y.dim() != 4 or y.dtype not in _DTYPE_CODES:
        raise ValueError(f"y must be a float32 or bfloat16 [N, C, H, W], got {y.dtype} "
                         f"{tuple(y.shape)}")
    n, c, h, w = y.shape
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y must be channels-last contiguous")
    if c > MAX_C:
        raise ValueError(f"C={c} exceeds the kernel's {MAX_C}")
    if bias.shape != (c,) or bias.dtype != torch.float32 or bias.device != y.device \
            or not bias.is_contiguous():
        raise ValueError(f"bias must be contiguous float32 [{c}] on {y.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if residual is not None and (
            residual.shape != y.shape or residual.dtype != y.dtype
            or residual.device != y.device
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"residual must be channels-last {y.dtype} {tuple(y.shape)} on "
                         f"{y.device}, got {residual.dtype} {tuple(residual.shape)} on "
                         f"{residual.device}")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    rows = n * h * w
    if rows > 2 ** 31 - 1:
        raise ValueError(f"N*H*W={rows} exceeds the kernel's int rows")
    tensors = (y, out) if residual is None else (y, out, residual)
    vec = vector_width(c, y.element_size(), *tensors)
    err = build.library().i2r_conv_epilogue(
        y.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(),
        out.data_ptr(), rows, c, int(bool(relu)), vec, _DTYPE_CODES[y.dtype],
        sm_count(y.device.index or 0), torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, "conv_epilogue kernel")
    tracing.count("kernel.conv_epilogue")
    return out
