"""Gaussian heatmap targets, batched on the device.

Port of ``i2rnet_tpu/ops/target.py::generate_targets`` (reference
``JointsDataset.py:394-450``): one closed-form grid evaluation over
``[..., K]`` joints. A joint's weight is its visibility, set to 0 when its
3-sigma support (int-truncated bounds, as the reference) falls wholly outside
the heatmap; its heatmap is ``exp(-((x - mu_x)^2 + (y - mu_y)^2) / (2 sigma^2))``
over the full grid where the weight exceeds 0.5, else zeros.
"""

from __future__ import annotations

import torch


def generate_targets(joints, joints_vis, heatmap_size, sigma: float):
    """joints [..., K, 2] in heatmap pixels, joints_vis [..., K] -> (target
    [..., K, h, w], target_weight [..., K]), float32; ``heatmap_size`` (w, h)."""
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    joints = joints.float()
    vis = joints_vis.float()
    mu_x, mu_y = joints[..., 0], joints[..., 1]
    tmp = 3.0 * sigma
    ul_x, ul_y = torch.trunc(mu_x - tmp), torch.trunc(mu_y - tmp)
    br_x, br_y = torch.trunc(mu_x + tmp + 1.0), torch.trunc(mu_y + tmp + 1.0)
    out_of_bounds = (ul_x >= w) | (ul_y >= h) | (br_x < 0) | (br_y < 0)
    weight = torch.where(out_of_bounds, 0.0, vis)
    gx = torch.arange(w, dtype=torch.float32, device=joints.device) - mu_x[..., None]
    gy = torch.arange(h, dtype=torch.float32, device=joints.device) - mu_y[..., None]
    g = torch.exp(-(gx[..., None, :] ** 2 + gy[..., :, None] ** 2) / (2.0 * sigma ** 2))
    target = torch.where((weight > 0.5)[..., None, None], g, 0.0)
    return target, weight
