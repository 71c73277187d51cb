"""Synthetic raw training batches, made with numpy from a seed.

A raw host batch in ``device_preprocess``'s contract, built as the JAX
``PoseDataset.make_raw_batch`` builds one for training (``data/dataset.py:
226-390``): per image a random uint8 raster and a rotation shared by its
persons; per person a box inside the image, its center and scale (reference
``coco.py:175-196``: aspect-ratio fix, /200, x1.25), the crop affine
``np_get_affine_transform(c, s, r)``, the position-mask affine of
``rotate_bound(r)`` + resize, the box's ramp bounds, and joints inside the
box (visible with probability 0.8) mapped to heatmap pixels. Padded slots
carry identity affines, far-away boxes and ``person_valid`` False. No flip,
pre-scaling or half-body augmentation. It stands in for the dataset reader,
which waits for the data slice.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from i2rnet_tpu_torch.ops.preprocess import np_rotate_bound_resize_affine
from i2rnet_tpu_torch.ops.transforms import np_get_affine_transform


def _box_center_scale(x, y, w, h, aspect: float):
    c = np.array([x + (w - 1) / 2, y + (h - 1) / 2], np.float32)
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return c, np.array([w / 200.0, h / 200.0], np.float32) * 1.25


def synthetic_raw_batch(cfg: Dict, person_counts: Sequence[int], rng: np.random.RandomState,
                        n_max: int = None, raw_hw: Tuple[int, int] = (480, 640),
                        max_rotation: float = 30.0) -> Dict[str, np.ndarray]:
    """One raw batch of ``len(person_counts)`` images with that many persons
    each, padded to ``n_max`` (default ``DATASET.MAX_PATCH``) person slots."""
    m = cfg["MODEL"]
    iw, ih = m["IMAGE_SIZE"]
    hw, hh = m["HEATMAP_SIZE"]
    k = m["NUM_JOINTS"]
    n_max = n_max or cfg["DATASET"]["MAX_PATCH"]
    b = len(person_counts)
    H, W = raw_hw
    raw = {
        "images": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
        "crop_affines": np.tile(np.eye(2, 3, dtype=np.float32), (b, n_max, 1, 1)),
        "boxes": np.full((b, n_max, 4), -1e6, np.float32),
        "mask_affines": np.tile(np.eye(2, 3, dtype=np.float32), (b, n_max, 1, 1)),
        "joints_hm": np.zeros((b, n_max, k, 2), np.float32),
        "joints_vis": np.zeros((b, n_max, k), np.float32),
        "person_valid": np.zeros((b, n_max), bool),
    }
    for bi, count in enumerate(person_counts):
        if count > n_max:
            raise ValueError(f"{count} persons do not fit {n_max} slots")
        r = float(rng.uniform(-max_rotation, max_rotation))
        mask_aff = np_rotate_bound_resize_affine(W, H, r, iw, ih)
        for pi in range(count):
            bw, bh = rng.uniform(W / 8, W / 2), rng.uniform(H / 4, H / 1.5)
            x0, y0 = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
            c, s = _box_center_scale(x0, y0, bw, bh, iw / ih)
            trans_hm = np_get_affine_transform(c, s, r, (hw, hh))
            joints = np.stack([rng.uniform(x0, x0 + bw, k), rng.uniform(y0, y0 + bh, k)], 1)
            vis = (rng.rand(k) < 0.8).astype(np.float32)
            jhm = joints @ trans_hm[:, :2].T + trans_hm[:, 2]
            x1i, y1i = np.trunc(x0), np.trunc(y0)
            x2i, y2i = np.trunc(x0 + bw), np.trunc(y0 + bh)
            raw["crop_affines"][bi, pi] = np_get_affine_transform(c, s, r, (iw, ih))
            raw["mask_affines"][bi, pi] = mask_aff
            raw["boxes"][bi, pi] = [x1i - 1 if x1i > 0 else -1e9, y1i - 1 if y1i > 0 else -1e9,
                                    x2i + 1 if x2i < W - 1 else 1e9,
                                    y2i + 1 if y2i < H - 1 else 1e9]
            raw["joints_hm"][bi, pi] = np.where(vis[:, None] > 0, jhm, joints)
            raw["joints_vis"][bi, pi] = vis
            raw["person_valid"][bi, pi] = True
    return raw
