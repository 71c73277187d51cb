"""Affine crop geometry (serving path).

Port of ``i2rnet_tpu/ops/transforms.py``: the batched analytic affine inverse,
the inverse crop affine that maps heatmap coordinates back to source pixels
(reference ``lib/utils/transforms.py:50-90``, pixel_std 200, rotation 0), and
the host-side numpy ``np_get_affine_transform`` (copied, as the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch


def _inv2x2(a):
    """Analytic [..., 2, 2] inverse (adjugate / det)."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def invert_affine(t):
    """Invert a [..., 2, 3] affine matrix."""
    a_inv = _inv2x2(t[..., :2, :2])
    b_inv = -torch.einsum("...ij,...j->...i", a_inv, t[..., :2, 2])
    return torch.cat([a_inv, b_inv[..., None]], dim=-1)


def _third_point(a, b):
    """b + perp(a - b) (reference transforms.py:99-101), over [..., 2]."""
    d = a - b
    return b + torch.stack([-d[..., 1], d[..., 0]], dim=-1)


def _solve_affine(src, dst):
    """Exact 3-point affine: src, dst [..., 3, 2] -> T [..., 2, 3], dst_i = T [src_i, 1]."""
    s = torch.stack([src[..., 0, :] - src[..., 2, :], src[..., 1, :] - src[..., 2, :]], dim=-1)
    d = torch.stack([dst[..., 0, :] - dst[..., 2, :], dst[..., 1, :] - dst[..., 2, :]], dim=-1)
    a_mat = d @ _inv2x2(s)
    t = dst[..., 2, :] - torch.einsum("...ij,...j->...i", a_mat, src[..., 2, :])
    return torch.cat([a_mat, t[..., None]], dim=-1)


def inverse_crop_affine(centers, scales, output_size):
    """The output-patch -> source affine of each (center, scale) box at
    rotation 0: ``get_affine_transform(c, s, 0, output_size, inv=True)``
    batched over ``centers``/``scales`` [P, 2] -> [P, 2, 3]."""
    scale_tmp = scales.float() * 200.0
    center = centers.float()
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    zero = torch.zeros_like(scale_tmp[:, 0])
    src0 = center
    src1 = center + torch.stack([zero, (scale_tmp[:, 0] - 1) * -0.5], dim=-1)
    src = torch.stack([src0, src1, _third_point(src0, src1)], dim=-2)
    dst0 = torch.tensor([(dst_w - 1) * 0.5, (dst_h - 1) * 0.5], device=center.device)
    dst1 = dst0 + torch.tensor([0.0, (dst_w - 1) * -0.5], device=center.device)
    dst = torch.stack([dst0, dst1, _third_point(dst0, dst1)], dim=-2).expand_as(src)
    return _solve_affine(dst, src)


def transform_preds_batch(coords, centers, scales, output_size):
    """coords [P, K, 2] heatmap pixels -> [P, K, 2] source-image pixels."""
    t = inverse_crop_affine(centers, scales, output_size)
    return torch.einsum("pij,pkj->pki", t[:, :, :2], coords) + t[:, None, :, 2]


def np_get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0), inv=False):
    """Host numpy crop affine (``i2rnet_tpu/ops/transforms.py:205``)."""
    center = np.asarray(center, np.float32)
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], np.float32)
    shift = np.asarray(shift, np.float32)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    sd = np.array([0, (src_w - 1) * -0.5], np.float32)
    src_dir = np.array([sd[0] * cs - sd[1] * sn, sd[0] * sn + sd[1] * cs], np.float32)
    dst_dir = np.array([0, (dst_w - 1) * -0.5], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    src[2] = third(src[0], src[1])
    dst[0] = [(dst_w - 1) * 0.5, (dst_h - 1) * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src
    a = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)
    x = np.linalg.solve(a, dst)
    return x.T.astype(np.float32)
