"""DETR-style transformer encoder with key-padding masks (batch-first).

Port of ``i2rnet_tpu/models/encoder.py``: post-norm layers, the position
embedding added to q and k (not v) in every layer, ReLU FFN. Tokens are
``[B, S, C]``; ``key_padding_mask`` is ``[B, S]`` (True = padded). Names are
``torch.nn.MultiheadAttention``'s (``in_proj_weight`` packs q/k/v) and the
reference's (``layers.{i}.linear1``...). With ``TransformerEncoder.use_kernels``
(``TPU.USE_PALLAS_ATTENTION``) the layers run the kernels, else their plain
versions:

* eval: the attention on Kernel A, the LN1 -> FFN -> residual -> LN2 tail on
  Kernel B;
* training (``module.training``), dropout ``dropout_rate`` (0.1, reference
  ``attention.py:37-112``): the attention with dropout on its weights on
  Kernel C where ``flash_train`` is on too (``TPU.FLASH_TRAIN_ATTENTION``),
  ``src + drop(attn)``, and the tail with both its dropouts on Kernel D where
  ``fused_ffn_train`` is on too (``TPU.FUSED_FFN_TRAIN``), as the JAX encoder
  routes them (``i2rnet_tpu/models/encoder.py:54,145``).

Training dropout is keyed by one seed per forward: layer i of an encoder
whose ``offset_base`` is b uses the offsets b + 4i (attention weights),
b + 4i + 1 (attention output, a ``bernoulli_`` draw from a generator seeded
with ``seed * 2^8 + offset``) and b + 4i + 2, b + 4i + 3 (the tail). Two
encoders of one model that share the step's seed take disjoint offset
ranges (the TransPose-H intra encoder starts at ``INTRA_OFFSET_BASE``, the
inter encoder at 0), so they draw independent bits, as the JAX encoders draw
from their own module RNG streams. Every offset stays below
``OFFSET_LIMIT``: the generator seed keeps 8 bits for it, and the HRFormer's
DropPath takes 255.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.layers import Linear
from i2rnet_tpu_torch.ops.attention import masked_mhsa, masked_mhsa_train
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused, encoder_ffn_torch
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import (encoder_ffn_train_fused,
                                                         encoder_ffn_train_torch)

OFFSETS_PER_LAYER = 4
#: the dropout offsets an encoder may use are below this (module docstring)
OFFSET_LIMIT = 255
#: the first offset of the TransPose-H intra encoder; the inter encoder's
#: offsets stay below it
INTRA_OFFSET_BASE = 128


def dropout(x, rate: float, seed: int, offset: int):
    """``where(keep, x / (1 - rate), 0)`` with keep ~ Bernoulli(1 - rate) drawn
    from a generator on x's device seeded by (seed, offset)."""
    if rate == 0.0:
        return x
    g = torch.Generator(device=x.device).manual_seed((int(seed) << 8) + int(offset))
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=g)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0).to(x.dtype)


class SelfAttention(nn.Module):
    """Packed q/k/v in-projection + out-projection around the masked MHSA."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_padding_mask=None, use_kernel: bool = False,
                dropout_rate: float = 0.0, dropout_seed=None, dropout_offset: int = 0):
        """Eval attention, or in training the attention with dropout on its weights."""
        c = query.shape[-1]
        w = self.in_proj_weight.to(query.dtype)
        b = self.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:c], b[:c])
        k = F.linear(key, w[c:2 * c], b[c:2 * c])
        v = F.linear(value, w[2 * c:], b[2 * c:])
        if self.training:
            out = masked_mhsa_train(q, k, v, self.num_heads, key_padding_mask, dropout_rate,
                                    dropout_seed, dropout_offset, use_kernel=use_kernel)
        else:
            out = masked_mhsa(q, k, v, self.num_heads, key_padding_mask, use_kernel=use_kernel)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm DETR encoder layer (reference ``attention.py:37-112``)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = SelfAttention(d_model, num_heads)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, key_padding_mask=None, pos: Optional[torch.Tensor] = None,
                use_kernels: bool = False, dropout_rate: float = 0.0, dropout_seed=None,
                offset: int = 0, flash_train: bool = True, fused_ffn_train: bool = True):
        qk = src if pos is None else src + pos
        tail = (self.norm1.weight, self.norm1.bias, self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias, self.norm2.weight, self.norm2.bias)
        if not self.training:
            src = src + self.self_attn(qk, qk, src, key_padding_mask, use_kernel=use_kernels)
            ffn = encoder_ffn_fused if use_kernels else encoder_ffn_torch
            return ffn(src, *tail, eps=self.norm1.eps)
        attn = self.self_attn(qk, qk, src, key_padding_mask, use_kernels and flash_train,
                              dropout_rate, dropout_seed, offset)
        src = src + dropout(attn, dropout_rate, dropout_seed, offset + 1)
        fused = use_kernels and fused_ffn_train
        ffn = encoder_ffn_train_fused if fused else encoder_ffn_train_torch
        return ffn(src, *tail, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                   dropout_offset=offset + 2, eps=self.norm1.eps)


class TransformerEncoder(nn.Module):
    """Stack of encoder layers over flat tokens ``[B, S, C]``. ``use_kernels``,
    ``flash_train``, ``fused_ffn_train`` and ``dropout_rate`` are settable; a
    training forward with a dropout rate above 0 needs ``dropout_seed``.
    Its dropout sites take the offsets :meth:`offsets` (from ``offset_base``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, use_kernels: bool = False, dropout_rate: float = 0.1,
                 flash_train: bool = True, fused_ffn_train: bool = True, offset_base: int = 0):
        super().__init__()
        if not 0 <= offset_base <= OFFSET_LIMIT - OFFSETS_PER_LAYER * num_layers:
            raise ValueError(f"{num_layers} layers from dropout offset {offset_base} pass "
                             f"the limit {OFFSET_LIMIT}")
        self.offset_base = offset_base
        self.use_kernels = use_kernels
        self.flash_train = flash_train
        self.fused_ffn_train = fused_ffn_train
        self.dropout_rate = dropout_rate
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward)
            for _ in range(num_layers)])

    def forward(self, src, key_padding_mask=None, pos=None, dropout_seed=None):
        rate = self.dropout_rate if self.training else 0.0
        if rate > 0.0 and dropout_seed is None:
            raise ValueError("a training forward with dropout needs dropout_seed")
        out = src
        for i, layer in enumerate(self.layers):
            out = layer(out, key_padding_mask, pos, self.use_kernels, rate, dropout_seed,
                        self.offset_base + OFFSETS_PER_LAYER * i, self.flash_train,
                        self.fused_ffn_train)
        return out

    def offsets(self) -> range:
        """The dropout offsets of this encoder's sites."""
        return range(self.offset_base, self.offset_base + OFFSETS_PER_LAYER * len(self.layers))


def flatten_person_tokens(x):
    """[B, N, H, W, C] -> [B, N*H*W, C] (person-major token order)."""
    b, n, h, w, c = x.shape
    return x.reshape(b, n * h * w, c)


def unflatten_person_tokens(tokens, n: int, h: int, w: int):
    """[B, N*H*W, C] -> [B, N, H, W, C]."""
    b, s, c = tokens.shape
    return tokens.reshape(b, n, h, w, c)
