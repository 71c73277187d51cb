"""Kernel A: masked multi-head self-attention (eval forward).

Replaces ``i2rnet_tpu/ops/pallas/mhsa.py::masked_mhsa_pallas``; the kernel is
``csrc/mhsa.cu``. :func:`masked_mhsa_torch` is its plain PyTorch version, with
the same numerics: the scale multiplies ``q`` in f32 before ``q . K^T``, padded
keys get the additive ``-1e30``, softmax and the ``. V`` accumulation run in
f32, and the output is cast to the input dtype.

Inputs are batch-first ``[B, S, C]`` with ``key_padding_mask`` ``[B, S]``
(True = padded key, the torch convention). A row whose keys are all padded
averages V uniformly over its S keys (finite), as ``masked_mhsa_xla`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from i2rnet_tpu_torch.ops.cuda import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head dim the kernel takes, in either dtype (``kMaxHeadDim``)
MAX_HEAD_DIM = 256


def check_heads(c: int, heads: int, b: int, max_dim: int = MAX_HEAD_DIM) -> int:
    """The head dim of ``C`` split into ``heads``; raises where the split is
    not even, the head dim exceeds ``max_dim`` or ``B * heads`` the grid."""
    if heads < 1 or c % heads != 0 or c // heads > max_dim:
        raise ValueError(f"C={c} must split into {heads} heads of dim <= {max_dim}")
    if b * heads > 65535:
        raise ValueError(f"B*heads={b * heads} exceeds the kernel grid")
    return c // heads


def masked_mhsa_torch(q, k, v, num_heads: int,
                      key_padding_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch masked MHSA on projected q/k/v ``[B, S, C]``."""
    b, s, c = q.shape
    h = num_heads
    d = c // h
    scale = 1.0 / (d ** 0.5)

    def heads(x):
        return x.reshape(b, s, h, d).transpose(1, 2).float()

    logits = torch.matmul(heads(q) * scale, heads(k).transpose(-1, -2))
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights, heads(v)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, s, c)


def fold_heads(x, heads: int):
    """``[B, S, H*d]`` -> contiguous ``[B*H, S, d]`` (x itself for one head)."""
    if heads == 1:
        return x if x.is_contiguous() else x.contiguous()
    b, s, c = x.shape
    return x.reshape(b, s, heads, c // heads).transpose(1, 2).reshape(b * heads, s,
                                                                      c // heads).contiguous()


def unfold_heads(x, heads: int):
    """``[B*H, S, d]`` -> ``[B, S, H*d]`` (x itself for one head)."""
    if heads == 1:
        return x
    bh, s, d = x.shape
    return x.reshape(bh // heads, heads, s, d).transpose(1, 2).reshape(bh // heads, s, heads * d)


def key_mask(key_padding_mask, b: int, s: int, device):
    """The ``[B, S]`` bool mask as the kernels take it (on ``device``,
    contiguous), or None; raises on another shape or type."""
    if key_padding_mask is None:
        return None
    if key_padding_mask.shape != (b, s) or key_padding_mask.dtype != torch.bool:
        raise ValueError(f"key_padding_mask must be bool [B, S] = {(b, s)}, got "
                         f"{key_padding_mask.dtype} {tuple(key_padding_mask.shape)}")
    mask = key_padding_mask if key_padding_mask.device == device else key_padding_mask.to(device)
    return mask if mask.is_contiguous() else mask.contiguous()


def masked_mhsa_fused(q, k, v, num_heads: int,
                      key_padding_mask: Optional[torch.Tensor] = None):
    """Masked MHSA through the CUDA kernel.

    CPU tensors take :func:`masked_mhsa_torch`; CUDA tensors launch the kernel
    or raise. Heads are folded into the batch (``[B*H, S, d]``, a view when
    H = 1); the head dim may be anything up to ``MAX_HEAD_DIM`` and S any length.
    """
    if q.device.type == "cpu":
        return masked_mhsa_torch(q, k, v, num_heads, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"masked_mhsa_fused: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share a [B, S, C] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must all be float32 or bfloat16, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    b, s, c = q.shape
    h = int(num_heads)
    d = check_heads(c, h, b)
    mask = key_mask(key_padding_mask, b, s, q.device)
    qf, kf, vf = fold_heads(q, h), fold_heads(k, h), fold_heads(v, h)
    out = torch.empty_like(qf)
    err = build.library().i2r_mhsa_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b * h, s, d, h, 1.0 / (d ** 0.5), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "masked_mhsa kernel")
    masked_mhsa_fused.launches += 1
    return unfold_heads(out, h)


masked_mhsa_fused.launches = 0
