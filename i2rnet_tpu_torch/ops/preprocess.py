"""Batched preprocessing on the device.

Port of ``i2rnet_tpu/ops/preprocess.py``. ``preprocess_inputs``: per-person
affine crop of the shared raw image (bilinear, zero border), ImageNet
normalisation, and the analytic soft-edged box mask that feeds the position
embedding. Two crop paths, as in the JAX package: the general bilinear gather,
and the axis-aligned one (every serving affine: no rotation) written as two
banded matmuls, one per axis. ``device_preprocess`` adds the training targets.
``np_rotate_bound_resize_affine`` is the host helper for the mask affine,
copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from i2rnet_tpu_torch.ops.target import generate_targets
from i2rnet_tpu_torch.ops.transforms import invert_affine

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _grid(inv, out_w: int, out_h: int):
    """Source coords of every output pixel: inv [..., 2, 3] -> sx, sy [..., h, w]."""
    ys = torch.arange(out_h, dtype=torch.float32, device=inv.device)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=inv.device)[None, :]

    def row(i):
        a, b, c = (inv[..., i, j, None, None] for j in range(3))
        return a * xs + b * ys + c

    return row(0), row(1)


def _bilinear_sample(imgs, sx, sy):
    """imgs [B, H, W, C]; sx, sy [B, N, h, w] -> [B, N, h, w, C], zero outside."""
    b, h_in, w_in, ch = imgs.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = imgs.reshape(b, h_in * w_in, ch)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w_in) & (yi >= 0) & (yi < h_in)
        idx = yi.clamp(0, h_in - 1) * w_in + xi.clamp(0, w_in - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, ch))
        return torch.where(valid[..., None], vals.reshape(*idx.shape, ch), 0.0)

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def _interp_weights(src_coords, src_size: int):
    """[..., out] source coords -> [..., out, src] rows of ``max(0, 1-|c-s|)``:
    two nonzero taps per in-range row, zero rows outside [0, src_size-1]."""
    s = torch.arange(src_size, dtype=torch.float32, device=src_coords.device)
    return torch.clamp(1.0 - torch.abs(src_coords[..., None] - s), min=0.0)


def _crop_axis_aligned(imgs, inv, out_w: int, out_h: int):
    """Bilinear crop when the affine has zero off-diagonals, as one banded
    matmul per axis. imgs [B, H, W, C], inv [B, N, 2, 3] -> [B, N, h, w, C]."""
    xs = torch.arange(out_w, dtype=torch.float32, device=imgs.device) * inv[..., 0, 0, None] \
        + inv[..., 0, 2, None]
    ys = torch.arange(out_h, dtype=torch.float32, device=imgs.device) * inv[..., 1, 1, None] \
        + inv[..., 1, 2, None]
    wy = _interp_weights(ys, imgs.shape[1])   # [B, N, h, H]
    wx = _interp_weights(xs, imgs.shape[2])   # [B, N, w, W]
    rows = torch.einsum("bnys,bswc->bnywc", wy, imgs)
    return torch.einsum("bnywc,bnxw->bnyxc", rows, wx)


def _pos_masks(boxes, mask_affines, out_w: int, out_h: int):
    """Analytic box masks with cv2's bilinear soft edges (see the JAX
    ``_pos_mask_one``): boxes [B, N, 4] ramp bounds, mask_affines
    [B, N, 2, 3] source -> output. Returns [B, N, h, w, 1] in [0, 1]."""
    sx, sy = _grid(invert_affine(mask_affines), out_w, out_h)
    bx = boxes[..., None, None, :]
    fx = torch.clamp(torch.minimum(sx - bx[..., 0], bx[..., 2] - sx), 0.0, 1.0)
    fy = torch.clamp(torch.minimum(sy - bx[..., 1], bx[..., 3] - sy), 0.0, 1.0)
    return (fx * fy)[..., None]


def preprocess_inputs(images, crop_affines, boxes, mask_affines,
                      image_size: Tuple[int, int], axis_aligned: bool = False):
    """images [B, maxH, maxW, 3] uint8 -> (crops [B, N, h, w, 3] normalised
    float32, pos_masks [B, N, h, w, 1]). ``image_size`` is (w, h);
    ``axis_aligned`` requires every crop affine to have zero off-diagonals."""
    w, h = int(image_size[0]), int(image_size[1])
    imgs = images.float() / 255.0
    inv = invert_affine(crop_affines.float())
    if axis_aligned:
        crops = _crop_axis_aligned(imgs, inv, w, h)
    else:
        crops = _bilinear_sample(imgs, *_grid(inv, w, h))
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device)
    std = torch.tensor(IMAGENET_STD, device=crops.device)
    return (crops - mean) / std, _pos_masks(boxes.float(), mask_affines.float(), w, h)


def device_preprocess(raw, image_size: Tuple[int, int], heatmap_size: Tuple[int, int],
                      sigma: float, joints_weight=None, axis_aligned: bool = False):
    """Raw host batch -> model batch, on the device of ``raw``'s tensors
    (``i2rnet_tpu/ops/preprocess.py:140-178``).

    ``raw``: images [B, maxH, maxW, 3] uint8; crop_affines [B, N, 2, 3];
    boxes [B, N, 4] x1y1x2y2; mask_affines [B, N, 2, 3]; joints_hm [B, N, K, 2]
    in heatmap pixels; joints_vis [B, N, K]; person_valid [B, N] bool.
    Returns images (normalised float32), pos_masks, target [B, N, K, h, w],
    target_weight [B, N, K] (times ``joints_weight`` when given,
    ``LOSS.USE_DIFFERENT_JOINTS_WEIGHT``), padded persons' targets and weights
    zeroed, and person_valid.
    """
    crops, pos_masks = preprocess_inputs(raw["images"], raw["crop_affines"], raw["boxes"],
                                         raw["mask_affines"], image_size,
                                         axis_aligned=axis_aligned)
    target, target_weight = generate_targets(raw["joints_hm"], raw["joints_vis"],
                                             heatmap_size, sigma)
    if joints_weight is not None:
        target_weight = target_weight * torch.as_tensor(joints_weight, dtype=torch.float32,
                                                        device=target_weight.device)
    valid = raw["person_valid"]
    vf = valid.to(torch.float32)
    return {"images": crops, "pos_masks": pos_masks,
            "target": target * vf[:, :, None, None, None],
            "target_weight": target_weight * vf[:, :, None],
            "person_valid": valid}


def np_rotate_bound_resize_affine(src_w: int, src_h: int, angle_deg: float,
                                  out_w: int, out_h: int) -> np.ndarray:
    """Host helper: the [2,3] source->output affine of ``rotate_bound(angle)``
    followed by ``cv2.resize`` to (out_w, out_h) (``i2rnet_tpu/ops/
    preprocess.py:181``; reference ``JointsDataset.py:180-202,324-325``)."""
    cx, cy = src_w // 2, src_h // 2
    a = np.deg2rad(angle_deg)
    cos, sin = np.cos(a), np.sin(a)
    m = np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                  [-sin, cos, sin * cx + (1 - cos) * cy]], np.float32)
    n_w = int(src_h * abs(sin) + src_w * abs(cos))
    n_h = int(src_h * abs(cos) + src_w * abs(sin))
    m[0, 2] += n_w / 2 - cx
    m[1, 2] += n_h / 2 - cy
    sx_r, sy_r = out_w / n_w, out_h / n_h
    r = np.array([[sx_r, 0, 0.5 * sx_r - 0.5],
                  [0, sy_r, 0.5 * sy_r - 0.5]], np.float32)
    m3 = np.vstack([m, [0, 0, 1]]).astype(np.float32)
    return (r @ m3).astype(np.float32)
