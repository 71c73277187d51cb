"""Position embedding from each person's box-mask image (eval path).

Port of ``i2rnet_tpu/models/position.py::PositionEmbeddingImage``, mode
``conv`` (the recipe's ``MODEL.MULTI_POS_EMBEDDING``): two stride-2 ConvBNs
(1 -> 64 -> d_model) then 3x3/2 max pools down to the token grid (reference
``position_embedding.py:24-32, 98-109``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.layers import Conv2d, MaskedBatchNorm, max_pool_3x3_s2


class PositionEmbeddingImage(nn.Module):
    """``[B, N, H, W, 1]`` box masks -> ``[B, N, th, tw, d_model]``."""

    def __init__(self, trans_size: Tuple[int, int], d_model: int = 96, mode: str = "conv"):
        super().__init__()
        if mode != "conv":
            raise NotImplementedError(
                f"position embedding mode {mode!r} is not ported (ROADMAP queue 1, item 3)")
        self.trans_size = tuple(trans_size)
        self.conv1 = Conv2d(1, 64, 3, 2, 1, bias=False)
        self.bn1 = MaskedBatchNorm(64)
        self.conv2 = Conv2d(64, d_model, 3, 2, 1, bias=False)
        self.bn2 = MaskedBatchNorm(d_model)

    def forward(self, pos_mask):
        b, n, h, w, _ = pos_mask.shape
        th, tw = self.trans_size
        x = pos_mask.reshape(b * n, 1, h, w)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for _ in range(int(math.log2(x.shape[3] // tw))):
            x = max_pool_3x3_s2(x)
        return x.permute(0, 2, 3, 1).reshape(b, n, th, tw, -1)
