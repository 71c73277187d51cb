"""Heatmap decoding on the device: argmax + DARK refinement + inverse affine.

Port of ``i2rnet_tpu/ops/decode.py`` (reference ``lib/core/inference.py:
20-112``): argmax with coords zeroed where the max is not positive; a
zero-padded separable Gaussian blur with cv2's ``getGaussianKernel(k, 0)``
coefficients, rescaled to each map's pre-blur max; log after clamping at
1e-10; one 2nd-order Taylor step at interior maxima with a nonsingular
Hessian; then the inverse crop affine.

The log is written ``log2(x) * ln(2)``: on the CPU ``torch.log`` goes to
MKL's vector math, as ``torch.exp`` does, whose first multi-threaded call in
a process can be off (``ops/cuda/mlp_dwbn.py``); ``torch.log2`` runs torch's
own kernel. The two agree within f32 rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from i2rnet_tpu_torch.ops.transforms import transform_preds_batch

#: cv2's hardcoded small-kernel table: getGaussianKernel(ksize, sigma<=0)
#: returns these fixed coefficients for ksize <= 7 (OpenCV smoothing.cpp).
CV2_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel1d(ksize: int) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, 0)`` without cv2: the small-kernel
    table, else the sigma formula (exact for the released BLUR_KERNEL=11)."""
    if ksize in CV2_SMALL_GAUSSIAN:
        return np.asarray(CV2_SMALL_GAUSSIAN[ksize], np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def get_max_preds(heatmaps):
    """heatmaps [..., K, H, W] -> (coords [..., K, 2] xy, maxvals [..., K, 1])."""
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], h * w)
    maxvals = torch.amax(flat, dim=-1, keepdim=True)
    idx = torch.argmax(flat, dim=-1)  # the first maximum, as jnp.argmax
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    coords = torch.stack([x, y], dim=-1)
    return torch.where(maxvals > 0.0, coords, 0.0), maxvals


def _band(n: int, k1d: np.ndarray, device) -> torch.Tensor:
    """[n, n] matrix applying the 1-D kernel with a zero border:
    ``(B @ x)[i] = sum_t k[t] x[i + t - r]``."""
    r = (len(k1d) - 1) // 2
    m = np.zeros((n, n), np.float32)
    for t, kv in enumerate(k1d):
        off = t - r
        i = np.arange(max(0, -off), min(n, n - off))
        m[i, i + off] = kv
    return torch.from_numpy(m).to(device)


def gaussian_blur(heatmaps, kernel: int = 11):
    """Zero-padded separable blur over [..., H, W] + max renormalisation
    (reference ``inference.py:73-87``), as two banded matmuls."""
    k1d = gaussian_kernel1d(kernel)
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    orig_max = torch.amax(heatmaps, dim=(-2, -1), keepdim=True)
    x = _band(h, k1d, heatmaps.device) @ heatmaps @ _band(w, k1d, heatmaps.device).t()
    new_max = torch.amax(x, dim=(-2, -1), keepdim=True)
    return x * orig_max / torch.clamp(new_max, min=1e-20)


def taylor_refine(log_hm, coords):
    """One 2nd-order Taylor step on log heatmaps [..., H, W] at integer argmax
    coords [..., 2] (reference ``inference.py:51-70``)."""
    h, w = log_hm.shape[-2], log_hm.shape[-1]
    px, py = coords[..., 0].long(), coords[..., 1].long()
    flat = log_hm.reshape(*log_hm.shape[:-2], h * w)

    def samp(dy, dx):
        yy = (py + dy).clamp(0, h - 1)
        xx = (px + dx).clamp(0, w - 1)
        return torch.take_along_dim(flat, (yy * w + xx)[..., None], dim=-1)[..., 0]

    c = samp(0, 0)
    dx = 0.5 * (samp(0, 1) - samp(0, -1))
    dy = 0.5 * (samp(1, 0) - samp(-1, 0))
    dxx = 0.25 * (samp(0, 2) - 2.0 * c + samp(0, -2))
    dxy = 0.25 * (samp(1, 1) - samp(-1, 1) - samp(1, -1) + samp(-1, -1))
    dyy = 0.25 * (samp(2, 0) - 2.0 * c + samp(-2, 0))

    det = dxx * dyy - dxy * dxy
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    off_x = -(dyy * dx - dxy * dy) * inv_det
    off_y = -(-dxy * dx + dxx * dy) * inv_det
    interior = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)
    valid = interior & (det != 0.0)
    offset = torch.stack([off_x, off_y], dim=-1)
    return coords + torch.where(valid[..., None], offset, 0.0)


def get_final_preds(heatmaps, centers, scales, blur_kernel: int = 11,
                    heatmap_size=None, post_process: bool = True):
    """heatmaps [P, K, H, W] f32, centers/scales [P, 2] -> (preds [P, K, 2] in
    source pixels, maxvals [P, K, 1]). ``heatmap_size`` is (w, h), by
    default the maps' own; ``post_process`` gates the DARK refinement."""
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    if heatmap_size is None:
        heatmap_size = (w, h)
    coords, maxvals = get_max_preds(heatmaps)
    if post_process:
        blurred = torch.clamp(gaussian_blur(heatmaps, blur_kernel), min=1e-10)
        hm = torch.log2(blurred) * math.log(2)
        coords = taylor_refine(hm, coords)
    return transform_preds_batch(coords, centers, scales, heatmap_size), maxvals
