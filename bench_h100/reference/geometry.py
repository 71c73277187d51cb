"""Request geometry and heatmap decoding of the reference, in numpy and torch.

Equations of the reference repo's ``lib/utils/transforms.py`` (crop affine,
pixel_std 200), ``lib/dataset/coco.py:175-196`` (box to center and scale,
aspect fixed, times 1.25), ``lib/dataset/JointsDataset.py`` (the rotated,
resized whole-image affine of the box mask, the Gaussian targets),
``lib/core/inference.py`` (argmax, DARK: an 11-tap Gaussian blur, log, one
Taylor step) and DETR's 2-D sine table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PIXEL_STD = 200.0


def affine_transform(center, scale, rot, output_size, inv=False) -> np.ndarray:
    """The [2, 3] source -> output crop affine of a (center, scale) box
    rotated by ``rot`` degrees; ``inv`` gives output -> source."""
    center = np.asarray(center, np.float64)
    scale_tmp = np.asarray(scale, np.float64) * PIXEL_STD
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    r = math.radians(rot)
    sd = np.array([0.0, (scale_tmp[0] - 1) * -0.5])
    src_dir = np.array([sd[0] * math.cos(r) - sd[1] * math.sin(r),
                        sd[0] * math.sin(r) + sd[1] * math.cos(r)])
    dst_dir = np.array([0.0, (dst_w - 1) * -0.5])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    src = np.stack([center, center + src_dir, third(center, center + src_dir)])
    d0 = np.array([(dst_w - 1) * 0.5, (dst_h - 1) * 0.5])
    dst = np.stack([d0, d0 + dst_dir, third(d0, d0 + dst_dir)])
    if inv:
        src, dst = dst, src
    a = np.concatenate([src, np.ones((3, 1))], axis=1)
    return np.linalg.solve(a, dst).T


def box_center_scale(box, image_size):
    """(x, y, w, h) -> center, scale: the box grown to the input's aspect, x1.25."""
    x, y, w, h = (float(v) for v in box)
    aspect = image_size[0] / image_size[1]
    center = np.array([x + (w - 1) / 2, y + (h - 1) / 2])
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return center, np.array([w, h]) / PIXEL_STD * 1.25


def box_ramp(box, img_w: int, img_h: int) -> np.ndarray:
    """The box mask's ramp bounds x1 y1 x2 y2: the box's integer corners one
    pixel out, open where the box touches the image border."""
    x, y, w, h = (float(v) for v in box)
    x1, y1, x2, y2 = math.trunc(x) - 1, math.trunc(y) - 1, math.trunc(x + w) + 1, math.trunc(y + h) + 1
    return np.array([-1e9 if x1 <= -1 else x1, -1e9 if y1 <= -1 else y1,
                     1e9 if x2 >= img_w else x2, 1e9 if y2 >= img_h else y2])


def whole_image_affine(src_w: int, src_h: int, angle: float, out_w: int, out_h: int):
    """The [2, 3] affine of the whole image rotated by ``angle`` degrees with
    its bounds kept, then resized to (out_w, out_h) with half-pixel centres."""
    cx, cy = src_w // 2, src_h // 2
    a = math.radians(angle)
    cos, sin = math.cos(a), math.sin(a)
    m = np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                  [-sin, cos, sin * cx + (1 - cos) * cy], [0.0, 0.0, 1.0]])
    n_w = int(src_h * abs(sin) + src_w * abs(cos))
    n_h = int(src_h * abs(cos) + src_w * abs(sin))
    m[0, 2] += n_w / 2 - cx
    m[1, 2] += n_h / 2 - cy
    sx, sy = out_w / n_w, out_h / n_h
    r = np.array([[sx, 0.0, 0.5 * sx - 0.5], [0.0, sy, 0.5 * sy - 0.5]])
    return r @ m


def _grid(inv: torch.Tensor, out_w: int, out_h: int):
    """Source coordinates of every output pixel of the [P, 2, 3] output -> source affines."""
    ys = torch.arange(out_h, dtype=torch.float32, device=inv.device)[None, :, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=inv.device)[None, None, :]
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    return sx, sy


def crops(image: torch.Tensor, inv: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Bilinear crops, zero outside the image: image [H, W, 3] uint8 on the
    device, inv [P, 2, 3] output -> source -> [P, h, w, 3] normalised float32."""
    h_in, w_in = image.shape[:2]
    sx, sy = _grid(inv, out_w, out_h)
    grid = torch.stack([sx * (2.0 / (w_in - 1)) - 1.0, sy * (2.0 / (h_in - 1)) - 1.0], dim=-1)
    img = (image.float() / 255.0).permute(2, 0, 1)[None].expand(inv.shape[0], -1, -1, -1)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    return (out.permute(0, 2, 3, 1) - mean) / std


def box_masks(ramps: torch.Tensor, mask_inv: torch.Tensor, out_w: int, out_h: int):
    """Soft-edged box masks [P, h, w, 1]: ramps [P, 4], mask_inv [P, 2, 3] output -> source."""
    sx, sy = _grid(mask_inv, out_w, out_h)
    r = ramps[:, None, None, :]
    fx = torch.clamp(torch.minimum(sx - r[..., 0], r[..., 2] - sx), 0.0, 1.0)
    fy = torch.clamp(torch.minimum(sy - r[..., 1], r[..., 3] - sy), 0.0, 1.0)
    return (fx * fy)[..., None]


def invert(aff: np.ndarray) -> np.ndarray:
    full = np.concatenate([aff, [[0.0, 0.0, 1.0]]], axis=0)
    return np.linalg.inv(full)[:2]


def sine_table(h: int, w: int, d_model: int) -> np.ndarray:
    """DETR's 2-D sine embedding [h*w, d_model]: y then x halves, sin/cos interleaved."""
    half = d_model // 2
    eps, scale = 1e-6, 2 * math.pi
    y = np.cumsum(np.ones((h, w)), axis=0)
    x = np.cumsum(np.ones((h, w)), axis=1)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = 10000.0 ** (2 * (np.arange(half) // 2) / half)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=2).reshape(h * w, d_model).astype(np.float32)


def targets(joints_hm: torch.Tensor, vis: torch.Tensor, heatmap_size, sigma: float):
    """Gaussian targets [..., K, h, w] and weights [..., K] of joints in heatmap pixels."""
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    mx, my = joints_hm[..., 0].double(), joints_hm[..., 1].double()
    tmp = 3 * sigma
    out = ((torch.trunc(mx - tmp) >= w) | (torch.trunc(my - tmp) >= h)
           | (torch.trunc(mx + tmp + 1) < 0) | (torch.trunc(my + tmp + 1) < 0))
    weight = torch.where(out, 0.0, vis.double())
    gx = torch.arange(w, dtype=torch.float64, device=mx.device) - mx[..., None]
    gy = torch.arange(h, dtype=torch.float64, device=mx.device) - my[..., None]
    g = torch.exp(-(gx[..., None, :] ** 2 + gy[..., :, None] ** 2) / (2 * sigma ** 2))
    return torch.where((weight > 0.5)[..., None, None], g, 0.0).float(), weight.float()


def flip_back(heat: torch.Tensor, pairs) -> torch.Tensor:
    """Heatmaps of a mirrored input [..., K, h, w] mirrored back, left and right joints swapped."""
    perm = list(range(heat.shape[-3]))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return heat.flip(-1)[..., perm, :, :]


def gaussian_1d(ksize: int) -> np.ndarray:
    """OpenCV's ``getGaussianKernel(ksize, 0)``: its fixed table up to 7 taps, else the sigma rule."""
    table = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
    if ksize in table:
        return np.asarray(table[ksize])
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def decode(heat: torch.Tensor, centers, scales, blur: int = 11):
    """DARK decode of heatmaps [P, K, h, w] (float32) -> dict of the source-pixel
    coordinates [P, K, 2], the peaks [P, K], the integer argmax [P, K, 2] and
    the Taylor offset [P, K, 2] in heatmap pixels (0 where not applied)."""
    p, k, h, w = heat.shape
    flat = heat.reshape(p, k, h * w)
    peak, idx = flat.max(-1)
    px, py = (idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()
    coords = torch.where((peak > 0)[..., None], torch.stack([px, py], -1), 0.0)
    k1 = torch.tensor(gaussian_1d(blur), dtype=torch.float32, device=heat.device)
    r = (blur - 1) // 2
    x = heat.reshape(p * k, 1, h, w)
    x = F.conv2d(F.conv2d(x, k1.view(1, 1, -1, 1), padding=(r, 0)), k1.view(1, 1, 1, -1),
                 padding=(0, r)).reshape(p, k, h, w)
    x = x * peak[..., None, None] / torch.clamp(x.amax((-2, -1), keepdim=True), min=1e-20)
    lg = torch.log(torch.clamp(x, min=1e-10)).reshape(p, k, h * w)
    cx, cy = coords[..., 0].long(), coords[..., 1].long()

    def at(dy, dx):
        return torch.gather(lg, -1, ((cy + dy).clamp(0, h - 1) * w + (cx + dx).clamp(0, w - 1))
                            [..., None])[..., 0]

    c = at(0, 0)
    dx, dy = 0.5 * (at(0, 1) - at(0, -1)), 0.5 * (at(1, 0) - at(-1, 0))
    dxx = 0.25 * (at(0, 2) - 2 * c + at(0, -2))
    dyy = 0.25 * (at(2, 0) - 2 * c + at(-2, 0))
    dxy = 0.25 * (at(1, 1) - at(-1, 1) - at(1, -1) + at(-1, -1))
    det = dxx * dyy - dxy * dxy
    ok = (cx > 1) & (cx < w - 2) & (cy > 1) & (cy < h - 2) & (det != 0)
    safe = torch.where(det == 0, 1.0, det)
    off = torch.stack([-(dyy * dx - dxy * dy) / safe, -(-dxy * dx + dxx * dy) / safe], -1)
    off = torch.where(ok[..., None], off, 0.0)
    hm = coords + off
    src = []
    for i in range(p):
        t = torch.tensor(affine_transform(centers[i], scales[i], 0, (w, h), inv=True),
                         dtype=torch.float32, device=heat.device)
        src.append(hm[i] @ t[:, :2].T + t[:, 2])
    return {"coords": torch.stack(src), "peak": peak, "argmax": coords, "offset": off,
            "interior": ok}
