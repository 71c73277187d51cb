"""Train-time PCK@0.5 accuracy on heatmaps, on the device.

Port of ``i2rnet_tpu/ops/accuracy.py`` (reference ``lib/core/evaluate.py:
16-71``): argmax-decode predicted and target heatmaps, normalise distances
by (h/10, w/10), count joints within ``thr``, ignoring joints whose target
argmax coordinates are <= 1 and padded persons.
"""

from __future__ import annotations

import torch

from i2rnet_tpu_torch.ops.decode import get_max_preds


def pck_accuracy(output, target, person_valid=None, thr: float = 0.5):
    """output, target [..., K, H, W]; person_valid [...] bool -> (mean accuracy,
    per-joint accuracy [K] (-1 where no joint has data), joints with data)."""
    return pck_from_counts(*pck_counts(output, target, person_valid, thr))


def pck_counts(output, target, person_valid=None, thr: float = 0.5):
    """Per joint, (hits [K], joints with data [K]): the sums that
    :func:`pck_from_counts` turns into the accuracy, which data-parallel
    training sums over the ranks first."""
    h, w = output.shape[-2], output.shape[-1]
    pred, _ = get_max_preds(output)
    gt, _ = get_max_preds(target)
    norm = torch.tensor([h / 10.0, w / 10.0], dtype=torch.float32, device=output.device)
    dists = torch.linalg.vector_norm((pred - gt) / norm, dim=-1)
    has_data = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    if person_valid is not None:
        has_data = has_data & person_valid[..., None]
    lead = tuple(range(dists.dim() - 1))
    cnt = has_data.sum(lead)
    hit = ((dists < thr) & has_data).sum(lead)
    return hit, cnt


def pck_from_counts(hit, cnt):
    """(mean accuracy, per-joint accuracy, joints with data) from the counts."""
    per_joint = torch.where(cnt > 0, hit / cnt.clamp_min(1), -1.0)
    joint_has = per_joint >= 0
    n_joints = joint_has.sum()
    avg = torch.where(n_joints > 0,
                      torch.where(joint_has, per_joint, 0.0).sum() / n_joints.clamp_min(1), 0.0)
    return avg, per_joint, n_joints
