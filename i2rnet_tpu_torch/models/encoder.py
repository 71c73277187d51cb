"""DETR-style transformer encoder with key-padding masks (batch-first), eval path.

Port of ``i2rnet_tpu/models/encoder.py``: post-norm layers, the position
embedding added to q and k (not v) in every layer, ReLU FFN. Tokens are
``[B, S, C]``; ``key_padding_mask`` is ``[B, S]`` (True = padded). Names are
``torch.nn.MultiheadAttention``'s (``in_proj_weight`` packs q/k/v) and the
reference's (``layers.{i}.linear1``...). With ``TransformerEncoder.use_kernels``
the attention runs Kernel A and the LN1 -> FFN -> residual -> LN2 tail runs
Kernel B; without, their plain versions. Training (dropout) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.layers import Linear
from i2rnet_tpu_torch.ops.attention import masked_mhsa
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused, encoder_ffn_torch


class SelfAttention(nn.Module):
    """Packed q/k/v in-projection + out-projection around the masked MHSA."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_padding_mask=None, use_kernel: bool = False):
        c = query.shape[-1]
        w = self.in_proj_weight.to(query.dtype)
        b = self.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:c], b[:c])
        k = F.linear(key, w[c:2 * c], b[c:2 * c])
        v = F.linear(value, w[2 * c:], b[2 * c:])
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
                use_kernels: bool = False):
        if self.training:
            raise NotImplementedError("the encoder's training path (dropout) is not ported")
        qk = src if pos is None else src + pos
        src = src + self.self_attn(qk, qk, src, key_padding_mask, use_kernel=use_kernels)
        ffn = encoder_ffn_fused if use_kernels else encoder_ffn_torch
        return ffn(src, self.norm1.weight, self.norm1.bias,
                   self.linear1.weight, self.linear1.bias,
                   self.linear2.weight, self.linear2.bias,
                   self.norm2.weight, self.norm2.bias, eps=self.norm1.eps)


class TransformerEncoder(nn.Module):
    """Stack of encoder layers over flat tokens ``[B, S, C]``. ``use_kernels``
    (settable) is the counterpart of ``TPU.USE_PALLAS_ATTENTION``."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, use_kernels: bool = False):
        super().__init__()
        self.use_kernels = use_kernels
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward)
            for _ in range(num_layers)])

    def forward(self, src, key_padding_mask=None, pos=None):
        out = src
        for layer in self.layers:
            out = layer(out, key_padding_mask, pos, self.use_kernels)
        return out


def flatten_person_tokens(x):
    """[B, N, H, W, C] -> [B, N*H*W, C] (person-major token order)."""
    b, n, h, w, c = x.shape
    return x.reshape(b, n * h * w, c)


def unflatten_person_tokens(tokens, n: int, h: int, w: int):
    """[B, N*H*W, C] -> [B, N, H, W, C]."""
    b, s, c = tokens.shape
    return tokens.reshape(b, n, h, w, c)
