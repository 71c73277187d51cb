"""The one traffic generator: requests and training batches from a mix's
parameters (``traffic/<mix>.json``) and ``--seed``.

Every seed gets the same amount of work in another order: person counts are
drawn by quota from the mix's distribution (``persons_pmf``, counts 1, 2,
...), so a pool of P requests holds round(P * pmf[k]) images of k persons,
then shuffled. Sizes, box positions, joints and augmentations are drawn from
the seed. Images are uint8 noise, made in bulk.

Keys of a mix: ``kind`` (``serve`` or ``train``); ``pool`` (requests, or
batches); ``persons_pmf``; ``image_h``, ``image_w`` ([lo, hi] pixels, within
the canvas ``canvas_hw``); ``cluster`` (persons per crowd cluster),
``cluster_spread`` (share of the image side a cluster spreads over),
``box_h`` ([lo, hi] share of the image height), ``box_aspect`` ([lo, hi]
width over height); serving ``in_flight`` and ``max_delay_ms``; training
``max_persons`` (the count's cap), ``visible`` (share of joints labelled),
``scale_factor``, ``rot_factor``, ``rot_prob``, ``flip``, ``half_body_prob``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from bench_h100.reference.geometry import (affine_transform, box_center_scale, box_ramp,
                                           whole_image_affine)


def quota_counts(pmf, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` person counts holding round(n * pmf[k]) of count k + 1 (largest
    remainders fill the rest), in an order drawn from ``rng``."""
    p = np.asarray(pmf, np.float64)
    p = p / p.sum()
    exact = p * n
    base = np.floor(exact).astype(int)
    rest = np.argsort(-(exact - base), kind="stable")[: n - base.sum()]
    base[rest] += 1
    counts = np.repeat(np.arange(1, len(p) + 1), base)
    return rng.permutation(counts)


def pmf_mean(pmf) -> float:
    p = np.asarray(pmf, np.float64)
    return float((p / p.sum()) @ np.arange(1, len(p) + 1))


def _boxes(mix, n: int, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` person boxes (x, y, w, h) inside an h x w image, in crowd clusters."""
    clusters = max(1, math.ceil(n / mix["cluster"]))
    centers = np.stack([rng.uniform(0.15 * w, 0.85 * w, clusters),
                        rng.uniform(0.25 * h, 0.75 * h, clusters)], 1)
    which = rng.integers(0, clusters, n)
    spread = mix["cluster_spread"] * np.array([w, h])
    bh = rng.uniform(*mix["box_h"], n) * h
    bw = np.minimum(bh * rng.uniform(*mix["box_aspect"], n), 0.9 * w)
    cx = centers[which, 0] + rng.normal(0, 1, n) * spread[0]
    cy = centers[which, 1] + rng.normal(0, 1, n) * spread[1]
    x0 = np.clip(cx - bw / 2, 0, w - bw - 1)
    y0 = np.clip(cy - bh / 2, 0, h - bh - 1)
    return np.stack([x0, y0, bw, bh], 1)


def _noise(rng: np.random.Generator, shapes) -> List[np.ndarray]:
    flat = rng.integers(0, 256, sum(int(np.prod(s)) for s in shapes), dtype=np.uint8)
    out, at = [], 0
    for s in shapes:
        size = int(np.prod(s))
        out.append(flat[at:at + size].reshape(s))
        at += size
    return out


def serve_requests(mix: Dict, seed: int):
    """The request pool: a list of (image [h, w, 3] uint8, boxes [[x, y, w, h], ...])."""
    rng = np.random.default_rng(int(seed))
    counts = quota_counts(mix["persons_pmf"], mix["pool"], rng)
    hs = rng.integers(mix["image_h"][0], mix["image_h"][1] + 1, len(counts))
    ws = rng.integers(mix["image_w"][0], mix["image_w"][1] + 1, len(counts))
    images = _noise(rng, [(int(h), int(w), 3) for h, w in zip(hs, ws)])
    return [(img, _boxes(mix, int(n), int(h), int(w), rng).tolist())
            for img, n, h, w in zip(images, counts, hs, ws)]


def train_batches(mix: Dict, cfg: Dict, flip_pairs, seed: int):
    """``mix["pool"]`` raw host batches in ``device_preprocess``'s input layout
    (images [B, H, W, 3] uint8 on the canvas, crop_affines and mask_affines
    [B, N, 2, 3], boxes [B, N, 4] ramp bounds, joints_hm [B, N, K, 2],
    joints_vis [B, N, K], person_valid [B, N]) of ``TRAIN.BATCH_SIZE_PER_GPU``
    images and ``DATASET.MAX_PATCH`` slots. Each image carries one scale,
    rotation and flip for all its persons; a person may be cut to its upper
    or lower body."""
    m, d = cfg["MODEL"], cfg["DATASET"]
    rng = np.random.default_rng(int(seed))
    b, n_max, k = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"], d["MAX_PATCH"], m["NUM_JOINTS"]
    (iw, ih), (hw, hh) = m["IMAGE_SIZE"], m["HEATMAP_SIZE"]
    H, W = mix["canvas_hw"]
    counts = np.minimum(quota_counts(mix["persons_pmf"], b * mix["pool"], rng), mix["max_persons"])
    upper = set(mix["upper_body"])
    batches = []
    for bi in range(mix["pool"]):
        raw = {"images": np.stack(_noise(rng, [(H, W, 3)] * b)),
               "crop_affines": np.tile(np.eye(2, 3, dtype=np.float32), (b, n_max, 1, 1)),
               "boxes": np.full((b, n_max, 4), -1e6, np.float32),
               "mask_affines": np.tile(np.eye(2, 3, dtype=np.float32), (b, n_max, 1, 1)),
               "joints_hm": np.zeros((b, n_max, k, 2), np.float32),
               "joints_vis": np.zeros((b, n_max, k), np.float32),
               "person_valid": np.zeros((b, n_max), bool)}
        for i in range(b):
            n = int(counts[bi * b + i])
            sf = float(np.clip(rng.normal() * mix["scale_factor"] + 1, 1 - mix["scale_factor"],
                               1 + mix["scale_factor"]))
            rot = float(np.clip(rng.normal() * mix["rot_factor"], -2 * mix["rot_factor"],
                                2 * mix["rot_factor"])) if rng.random() < mix["rot_prob"] else 0.0
            flip = bool(mix["flip"] and rng.random() < 0.5)
            if flip:
                raw["images"][i] = raw["images"][i, :, ::-1]
            mask_aff = whole_image_affine(W, H, rot, iw, ih)
            for j, box in enumerate(_boxes(mix, n, H, W, rng)):
                joints = np.stack([rng.uniform(box[0], box[0] + box[2], k),
                                   rng.uniform(box[1], box[1] + box[3], k)], 1)
                vis = (rng.random(k) < mix["visible"]).astype(np.float32)
                if flip:
                    box = np.array([W - box[0] - box[2], box[1], box[2], box[3]])
                    joints[:, 0] = W - 1 - joints[:, 0]
                    for a, c in flip_pairs:
                        joints[[a, c]], vis[[a, c]] = joints[[c, a]], vis[[c, a]]
                center, scale = box_center_scale(box, (iw, ih))
                if rng.random() < mix["half_body_prob"] and vis.sum() > d["NUM_JOINTS_HALF_BODY"]:
                    side = rng.random() < 0.5
                    part = [q for q in range(k) if (q in upper) == side and vis[q]]
                    if len(part) >= 2:
                        lo, hi = joints[part].min(0), joints[part].max(0)
                        center, scale = box_center_scale([lo[0], lo[1], hi[0] - lo[0] + 1,
                                                          hi[1] - lo[1] + 1], (iw, ih))
                        scale = scale * 1.5 / 1.25
                scale = scale * sf
                raw["crop_affines"][i, j] = affine_transform(center, scale, rot, (iw, ih))
                t = affine_transform(center, scale, rot, (hw, hh))
                raw["joints_hm"][i, j] = joints @ t[:, :2].T + t[:, 2]
                raw["joints_vis"][i, j] = vis
                raw["mask_affines"][i, j] = mask_aff
                raw["boxes"][i, j] = box_ramp(box, W, H)
                raw["person_valid"][i, j] = True
        batches.append(raw)
    return batches
