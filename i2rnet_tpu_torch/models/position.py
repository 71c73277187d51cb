"""Position embeddings.

* :func:`sine_position_embedding_2d`: the DETR 2D sine embedding over an
  (h, w) grid, a copy of ``i2rnet_tpu/models/position.py:28-49`` (reference
  ``interformer_pureMulti.py:516-541``); TransPose-H adds it to q and k of
  its intra encoder.
* :class:`PositionEmbeddingImage`: each person's box-mask image embedded
  into per-token embeddings, port of the JAX ``PositionEmbeddingImage``,
  modes ``conv`` (the recipes' ``MODEL.MULTI_POS_EMBEDDING``: two stride-2
  ConvBNs, 1 -> 64 -> d_model, then 3x3/2 max pools down to the token grid;
  reference ``position_embedding.py:24-32, 98-109``) and ``res`` (OCHuman
  TPH's: a 3x3 conv 1 -> 3, the ResNet-18 stem and ``layer1``, a 3x3 conv
  64 -> d_model, then the pools; reference ``:14-18, 94-97``). In training
  its BNs normalise over the valid persons (``MaskedBatchNorm.person_mask``,
  set by the owning model, the JAX ``person_valid`` argument).

Modes ``sine`` and ``cat_vec`` are not ported (ROADMAP queue 1): building
one raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.layers import (BasicBlock, Conv2d, MaskedBatchNorm,
                                            max_pool_3x3_s2)


def sine_position_embedding_2d(h: int, w: int, d_model: int,
                               temperature: float = 10000.0,
                               scale: float = 2 * math.pi) -> np.ndarray:
    """[h*w, d_model] sine PE, matching the reference construction exactly
    (cumsum-normalized y/x, interleaved sin/cos, y-block then x-block)."""
    one_direction = d_model // 2
    y_embed = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x_embed = np.cumsum(np.ones((h, w), np.float32), axis=1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(one_direction, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / one_direction)

    pos_x = x_embed[:, :, None] / dim_t  # [h, w, D/2]
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2)  # [h, w, d_model]
    return pos.reshape(h * w, d_model).astype(np.float32)


class PositionEmbeddingImage(nn.Module):
    """``[B, N, H, W, 1]`` box masks -> ``[B, N, th, tw, d_model]``."""

    def __init__(self, trans_size: Tuple[int, int], d_model: int = 96, mode: str = "conv"):
        super().__init__()
        self.trans_size = tuple(trans_size)
        self.mode = mode
        if mode == "conv":
            self.conv1 = Conv2d(1, 64, 3, 2, 1, bias=False)
            self.bn1 = MaskedBatchNorm(64)
            self.conv2 = Conv2d(64, d_model, 3, 2, 1, bias=False)
            self.bn2 = MaskedBatchNorm(d_model)
        elif mode == "res":
            self.conv_pre = Conv2d(1, 3, 3, 1, 1, bias=False)
            # torchvision resnet18's children()[:5]: conv1, bn1, relu, maxpool, layer1
            self.res = nn.Sequential(Conv2d(3, 64, 7, 2, 3, bias=False), MaskedBatchNorm(64),
                                     nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                                     nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64)))
            self.conv_end = Conv2d(64, d_model, 3, 1, 1, bias=False)
        else:
            raise NotImplementedError(f"position embedding mode {mode!r} is not ported "
                                      "(ROADMAP queue 1)")

    def forward(self, pos_mask):
        b, n, h, w, _ = pos_mask.shape
        th, tw = self.trans_size
        x = pos_mask.reshape(b * n, 1, h, w)
        if self.mode == "conv":
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.relu(self.bn2(self.conv2(x)))
        else:
            x = self.conv_end(self.res(self.conv_pre(x)))
        for _ in range(int(math.log2(x.shape[3] // tw))):
            x = max_pool_3x3_s2(x)
        return x.permute(0, 2, 3, 1).reshape(b, n, th, tw, -1)
