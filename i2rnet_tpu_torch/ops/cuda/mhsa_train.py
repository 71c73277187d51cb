"""Kernel C: masked MHSA with attention-weight dropout (training).

Replaces ``i2rnet_tpu/ops/pallas/mhsa_train.py::masked_mhsa_train``; the
kernels are ``csrc/mhsa_train.cu`` (forward; backward for dQ, dK, dV).
:func:`masked_mhsa_train_torch` is the plain PyTorch version under autograd,
with the numerics of ``mhsa_train.py``: ``q . K^T`` in f32 times the scale,
``-1e30`` added at padded keys, softmax in f32, survivors of the dropout
scaled by ``1/(1-rate)``, the probabilities cast to the activation type
before ``. V`` (``mhsa_train.py:100``).

Inputs are ``[B, S, C]`` with H heads, folded to ``[B*H, S, d]`` (head index
``b*H + h``). Dropout (``ops/cuda/dropout.py``): ``dropout_bits`` ``[B*H, S,
S]``, or ``dropout_seed`` with ``dropout_offset`` (Philox counted by (key,
query, b*H + h)). A fully padded image averages V over its S keys (finite).
"""

from __future__ import annotations

from typing import Optional

import torch

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.dropout import (as_words, check_mode, kernel_args, keep_mask,
                                               philox_bits)
from i2rnet_tpu_torch.ops.cuda.mhsa import (_DTYPE_CODES, check_heads, fold_heads, key_mask,
                                            unfold_heads)

NEG_INF = -1e30
#: the widest head dim the kernels take in bf16, and in f32, whose CUDA-core
#: dK/dV block at 192 takes 231680 of a block's 232448 B (``kMaxHeadDim``,
#: ``kMaxHeadDimF32``)
MAX_HEAD_DIM = 256
MAX_HEAD_DIM_F32 = 192


def attention_bits(seed: int, offset: int, bh: int, s: int, device=None, first: int = 0):
    """The seed-mode dropout bits ``[bh, s, s]`` (int64) of heads ``first``
    .. ``first + bh - 1`` (index b*H + h), as the kernel draws them."""
    idx = torch.arange(s, device=device)
    return philox_bits(seed, offset, idx[None, None, :], idx[None, :, None],
                       torch.arange(first, first + bh, device=device)[:, None, None])


def masked_mhsa_train_torch(q, k, v, num_heads: int,
                            key_padding_mask: Optional[torch.Tensor] = None,
                            dropout_rate: float = 0.0, dropout_bits=None,
                            dropout_seed: Optional[int] = None, dropout_offset: int = 0):
    """Plain PyTorch training attention on projected q/k/v ``[B, S, C]``."""
    b, s, c = q.shape
    h = num_heads
    d = c // h
    mode = check_mode(dropout_rate, dropout_bits, dropout_seed)

    def heads(x):
        return x.reshape(b, s, h, d).transpose(1, 2).float()

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * (1.0 / d ** 0.5)
    if key_padding_mask is not None:
        bias = torch.zeros(b, s, device=q.device).masked_fill(key_padding_mask, NEG_INF)
        logits = logits + bias[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    if mode != "none":
        bits = (dropout_bits if mode == "bits"
                else attention_bits(dropout_seed, dropout_offset, b * h, s, q.device))
        keep = keep_mask(bits, dropout_rate).view(b, h, s, s)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.matmul(p.to(q.dtype).float(), heads(v)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, s, c)


def _dropout_args(mode, rate, words, seed, offset):
    return (None if words is None else words.data_ptr(), *kernel_args(mode, rate, seed, offset))


def mhsa_train_fwd(qf, kf, vf, heads: int, mask, mode: str, rate: float, words, seed, offset):
    """Launch the forward kernels on folded ``[B*H, S, d]`` tensors; returns
    ``(out, out32, row_m, row_l, keep)``: the f32 output, each row's max (in
    base 2 on the bf16 route) and sum, kept for the backward, and on the bf16
    route with dropout the keep bits ``[B*H, S, ceil(S / 32)]`` that its
    first kernel draws (else None)."""
    bh, s, d = qf.shape
    out = torch.empty_like(qf)
    out32 = torch.empty(qf.shape, device=qf.device, dtype=torch.float32)
    row_m = torch.empty(bh, s, device=qf.device, dtype=torch.float32)
    row_l = torch.empty_like(row_m)
    keep = None
    if qf.dtype == torch.bfloat16 and mode != "none":
        keep = torch.empty(bh, s, (s + 31) // 32, device=qf.device, dtype=torch.int32)
    err = build.library().i2r_mhsa_train_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), out32.data_ptr(), row_m.data_ptr(), row_l.data_ptr(),
        bh, s, d, heads, 1.0 / d ** 0.5, _DTYPE_CODES[qf.dtype],
        *_dropout_args(mode, rate, words, seed, offset), None if keep is None else keep.data_ptr(),
        torch.cuda.current_stream(qf.device).cuda_stream)
    build.check(err, "mhsa_train forward kernel")
    tracing.count("kernel.mhsa_train_fwd")
    return out, out32, row_m, row_l, keep


def mhsa_train_bwd(qf, kf, vf, heads: int, mask, gout, out32, row_m, row_l, keep, mode: str,
                   rate: float, words, seed, offset):
    """Launch the backward kernels (rowsum(dO o O), dK/dV, dQ); returns ``(dq, dk, dv)``."""
    bh, s, d = qf.shape
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    row_d = torch.empty_like(row_m)
    err = build.library().i2r_mhsa_train_bwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), None if mask is None else mask.data_ptr(),
        gout.data_ptr(), out32.data_ptr(), row_m.data_ptr(), row_l.data_ptr(), row_d.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, d, heads, 1.0 / d ** 0.5,
        _DTYPE_CODES[qf.dtype], *_dropout_args(mode, rate, words, seed, offset),
        None if keep is None else keep.data_ptr(), torch.cuda.current_stream(qf.device).cuda_stream)
    build.check(err, "mhsa_train backward kernels")
    tracing.count("kernel.mhsa_train_bwd")
    return dq, dk, dv


class _MhsaTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, mask, mode, rate, words, seed, offset):
        qf, kf, vf = fold_heads(q, heads), fold_heads(k, heads), fold_heads(v, heads)
        out, out32, row_m, row_l, keep = mhsa_train_fwd(qf, kf, vf, heads, mask, mode, rate,
                                                        words, seed, offset)
        ctx.save_for_backward(qf, kf, vf, out32, row_m, row_l, keep, mask, words)
        ctx.config = (heads, mode, rate, seed, offset)
        return unfold_heads(out, heads)

    @staticmethod
    def backward(ctx, gout):
        qf, kf, vf, out32, row_m, row_l, keep, mask, words = ctx.saved_tensors
        heads, mode, rate, seed, offset = ctx.config
        g = fold_heads(gout if gout.dtype == qf.dtype else gout.to(qf.dtype), heads)
        dq, dk, dv = mhsa_train_bwd(qf, kf, vf, heads, mask, g, out32, row_m, row_l, keep, mode,
                                    rate, words, seed, offset)
        return (unfold_heads(dq, heads), unfold_heads(dk, heads), unfold_heads(dv, heads),
                None, None, None, None, None, None, None)


def masked_mhsa_train_fused(q, k, v, num_heads: int,
                            key_padding_mask: Optional[torch.Tensor] = None,
                            dropout_rate: float = 0.0, dropout_bits=None,
                            dropout_seed: Optional[int] = None, dropout_offset: int = 0):
    """Training attention through the CUDA kernels, differentiable in q, k, v.

    CPU tensors take :func:`masked_mhsa_train_torch`; CUDA tensors launch the
    kernels or raise. The head dim may be anything up to ``MAX_HEAD_DIM`` in bf16
    and ``MAX_HEAD_DIM_F32`` in f32, and S any length.
    """
    if q.device.type == "cpu":
        return masked_mhsa_train_torch(q, k, v, num_heads, key_padding_mask, dropout_rate,
                                       dropout_bits, dropout_seed, dropout_offset)
    if q.device.type != "cuda":
        raise ValueError(f"masked_mhsa_train_fused: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share a [B, S, C] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must all be float32 or bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    b, s, c = q.shape
    h = int(num_heads)
    check_heads(c, h, b, MAX_HEAD_DIM if q.dtype == torch.bfloat16 else MAX_HEAD_DIM_F32)
    mask = key_mask(key_padding_mask, b, s, q.device)
    mode = check_mode(dropout_rate, dropout_bits, dropout_seed)
    words = None
    if mode == "bits":
        if tuple(dropout_bits.shape) != (b * h, s, s):
            raise ValueError(f"dropout_bits must be [B*H, S, S] = {(b * h, s, s)}, "
                             f"got {tuple(dropout_bits.shape)}")
        words = as_words(dropout_bits.to(q.device))
    return _MhsaTrain.apply(q, k, v, h, mask, mode, float(dropout_rate), words,
                            None if dropout_seed is None else int(dropout_seed),
                            int(dropout_offset))
