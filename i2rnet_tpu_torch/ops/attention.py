"""Masked multi-head self-attention: the plain version and the dispatch.

Port of ``i2rnet_tpu/ops/attention.py`` (eval path). Inputs are batch-first
``[B, S, C]``; ``key_padding_mask`` is ``[B, S]`` with True = padded. The
plain version lives beside its kernel in :mod:`i2rnet_tpu_torch.ops.cuda.mhsa`.
"""

from __future__ import annotations

from typing import Optional

import torch

from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused, masked_mhsa_torch

__all__ = ["masked_mhsa", "masked_mhsa_torch"]


def masked_mhsa(q, k, v, num_heads: int,
                key_padding_mask: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
    """Kernel A when ``use_kernel`` (the counterpart of
    ``TPU.USE_PALLAS_ATTENTION``), else the plain version. No fallback: the
    kernel path raises if the kernel cannot run on a CUDA tensor."""
    fn = masked_mhsa_fused if use_kernel else masked_mhsa_torch
    return fn(q, k, v, num_heads, key_padding_mask)
