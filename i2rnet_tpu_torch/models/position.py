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
  set by the owning model, the JAX ``person_valid`` argument); ``sine``
  (no parameters: the multi-person sine table of
  :func:`sine_position_embedding_multi` over the token grid, the same for
  every image; reference ``:89-91``); and ``cat_vec`` (the box mask
  max-pooled to the token grid, flattened, one ``Linear`` ``fc`` to
  ``vec_dim`` and that vector broadcast over the person's tokens; reference
  ``:19-23, 69-88``). The owner of a ``cat_vec`` embedding concatenates it to
  the channels rather than adding it (``models/interformer.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.layers import (BasicBlock, Conv2d, Linear, MaskedBatchNorm,
                                            max_pool_3x3_s2)

#: the modes ported, as ``MODEL.MULTI_POS_EMBEDDING`` names them
MODES = ("conv", "res", "sine", "cat_vec")


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


def sine_position_embedding_multi(n: int, h: int, w: int, d_model: int) -> np.ndarray:
    """[n, h, w, d_model]: the 2D sine table over the (h, n*w) grid of the
    persons side by side, person i in columns i*w .. (i+1)*w - 1 (a copy of
    ``i2rnet_tpu/models/position.py:51-59``, reference
    ``position_embedding.py:34-62``)."""
    wide = sine_position_embedding_2d(h, n * w, d_model).reshape(h, n * w, d_model)
    return np.stack([wide[:, i * w:(i + 1) * w, :] for i in range(n)], axis=0)


class PositionEmbeddingImage(nn.Module):
    """``[B, N, H, W, 1]`` box masks -> ``[B, N, th, tw, d_model]`` (``cat_vec``:
    ``[B, N, th, tw, vec_dim]``, ``vec_dim`` d_model where not given)."""

    def __init__(self, trans_size: Tuple[int, int], d_model: int = 96, mode: str = "conv",
                 vec_dim=None):
        super().__init__()
        self.trans_size = tuple(trans_size)
        self.d_model = d_model
        self.mode = mode
        self._sine = {}
        if mode == "cat_vec":
            self.fc = Linear(self.trans_size[0] * self.trans_size[1], vec_dim or d_model)
        elif mode == "conv":
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
        elif mode != "sine":  # sine: no parameters
            raise ValueError(f"position embedding mode {mode!r}: expected one of {MODES}")

    def sine_table(self, n: int, dtype, device):
        """The ``sine`` mode's ``[n, th, tw, d_model]`` table, made once per
        (n, dtype, device)."""
        key = (n, dtype, device)
        if key not in self._sine:
            pe = sine_position_embedding_multi(n, *self.trans_size, self.d_model)
            self._sine[key] = torch.from_numpy(pe).to(device, dtype)
        return self._sine[key]

    def forward(self, pos_mask):
        b, n, h, w, _ = pos_mask.shape
        th, tw = self.trans_size
        if self.mode == "sine":
            dt = pos_mask.dtype if pos_mask.is_floating_point() else torch.float32
            return self.sine_table(n, dt, pos_mask.device)[None].expand(b, n, th, tw,
                                                                       self.d_model)
        x = pos_mask.reshape(b * n, 1, h, w)
        if self.mode == "cat_vec":
            for _ in range(int(math.log2(w // tw))):
                x = max_pool_3x3_s2(x)
            vec = self.fc(x.reshape(b * n, -1)).reshape(b, n, 1, 1, -1)
            return vec.expand(b, n, th, tw, vec.shape[-1])
        if self.mode == "conv":
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.relu(self.bn2(self.conv2(x)))
        else:
            x = self.conv_end(self.res(self.conv_pre(x)))
        for _ in range(int(math.log2(x.shape[3] // tw))):
            x = max_pool_3x3_s2(x)
        return x.permute(0, 2, 3, 1).reshape(b, n, th, tw, -1)
