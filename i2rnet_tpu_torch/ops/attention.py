"""Masked multi-head self-attention: the plain versions and the dispatch.

Port of ``i2rnet_tpu/ops/attention.py``. Inputs are batch-first ``[B, S,
C]``; ``key_padding_mask`` is ``[B, S]`` with True = padded. The plain
versions live beside their kernels: eval in :mod:`i2rnet_tpu_torch.ops.cuda.mhsa`
(Kernel A), training with dropout on the attention weights in
:mod:`i2rnet_tpu_torch.ops.cuda.mhsa_train` (Kernel C).
"""

from __future__ import annotations

from typing import Optional

import torch

from i2rnet_tpu_torch.ops.cuda.library import route
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_torch
from i2rnet_tpu_torch.ops.cuda.mhsa_train import masked_mhsa_train_fused, masked_mhsa_train_torch

__all__ = ["masked_mhsa", "masked_mhsa_torch", "masked_mhsa_train", "masked_mhsa_train_torch"]


def masked_mhsa(q, k, v, num_heads: int,
                key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
    """Kernel A when ``use_kernel`` (the counterpart of
    ``TPU.USE_PALLAS_ATTENTION``), else the plain version. No fallback: the
    kernel path raises if the kernel cannot run on a CUDA tensor. While
    ``torch.export`` traces, the kernel is its registered op ``i2r::masked_mhsa``."""
    fn = route("masked_mhsa") if use_kernel else masked_mhsa_torch
    return fn(q, k, v, num_heads, key_padding_mask)


def masked_mhsa_train(q, k, v, num_heads: int,
                      key_padding_mask: Optional[torch.Tensor] = None,
                      dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                      dropout_offset: int = 0, use_kernel: bool = False):
    """Training attention (dropout on the attention weights, seed mode):
    Kernel C when ``use_kernel`` (``TPU.FLASH_TRAIN_ATTENTION``), else its
    plain version. No fallback."""
    fn = masked_mhsa_train_fused if use_kernel else masked_mhsa_train_torch
    return fn(q, k, v, num_heads, key_padding_mask, dropout_rate,
              dropout_seed=dropout_seed, dropout_offset=dropout_offset)
