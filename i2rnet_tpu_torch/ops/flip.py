"""Flip-test heatmap un-flipping (port of ``i2rnet_tpu/ops/flip.py::flip_back``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def flip_back(output_flipped, matched_parts: Sequence[Tuple[int, int]]):
    """Un-flip heatmaps predicted on a mirrored input, [..., K, H, W]: reverse
    the width axis, then swap left/right joint channels (reference
    ``transforms.py:16-30``)."""
    perm = list(range(output_flipped.shape[-3]))
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    idx = torch.tensor(perm, device=output_flipped.device)
    return torch.index_select(output_flipped.flip(-1), -3, idx)
