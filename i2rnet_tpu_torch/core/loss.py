"""Heatmap MSE losses under the person mask.

Port of ``i2rnet_tpu/core/loss.py`` (reference ``lib/core/loss.py:15-86``):
padded persons add nothing to the numerator or the denominator, so a padded
``[B, N]`` batch gives the loss of its ragged persons.
"""

from __future__ import annotations

import torch


def _rows(output, target, target_weight):
    k, hw = output.shape[-3], output.shape[-2] * output.shape[-1]
    lead = output.shape[:-3]
    pred = output.reshape(*lead, k, hw)
    gt = target.reshape(*lead, k, hw)
    if target_weight is not None:
        pred = pred * target_weight[..., None]
        gt = gt * target_weight[..., None]
    return pred, gt, lead, hw


def joints_mse_loss(output, target, target_weight=None, person_valid=None, count=None):
    """``mean_j 0.5 * mean_{valid persons, pixels} (pred_j w - gt_j w)^2``;
    output, target [..., K, H, W], target_weight [..., K], person_valid [...].
    ``count``, where given, is the number of valid persons to divide by in
    place of ``person_valid``'s (the global batch's under data parallelism:
    each rank's loss is then its part of the global loss)."""
    pred, gt, lead, hw = _rows(output, target, target_weight)
    sq = (pred - gt) ** 2
    if person_valid is not None:
        sq = sq * person_valid[..., None, None].to(sq.dtype)
        n_rows = (person_valid.sum() if count is None else count).to(sq.dtype)
    else:
        n_rows = torch.tensor(float(lead.numel()), dtype=sq.dtype, device=sq.device)
    lead_axes = tuple(range(len(lead)))
    per_joint = sq.sum(lead_axes + (-1,)) / torch.clamp(n_rows * hw, min=1)
    return 0.5 * per_joint.mean()


def joints_ohkm_mse_loss(output, target, target_weight=None, person_valid=None, topk: int = 8,
                         count=None):
    """Online hard-keypoint mining: per person the mean of its ``topk`` largest
    per-joint MSEs, averaged over the valid persons (``count`` of them where
    given, as :func:`joints_mse_loss`)."""
    pred, gt, _, _ = _rows(output, target, target_weight)
    per_joint = 0.5 * ((pred - gt) ** 2).mean(-1)
    per_sample = torch.topk(per_joint, topk, dim=-1).values.sum(-1) / topk
    if person_valid is not None:
        m = person_valid.to(per_sample.dtype)
        n = m.sum() if count is None else count.to(per_sample.dtype)
        return (per_sample * m).sum() / torch.clamp(n, min=1)
    return per_sample.mean()
