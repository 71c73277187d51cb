"""The reference's answer to one served request, and what the comparison reads of it.

A request is an image and its person boxes. As the served program does, the
boxes are split into rows of at most ``n_max`` persons in their order; each
row is one forward over its persons only (the padded slots of a served
batch are masked out of attention and change nothing), and a second one on
the mirrored crops averaged in (flip test); then DARK decodes each joint.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.geometry import (affine_transform, box_center_scale, box_masks,
                                           box_ramp, crops, decode, flip_back, invert,
                                           whole_image_affine)

#: a peak is unambiguous where no pixel farther than this (heatmap pixels,
#: per axis) from the argmax comes within the margin below it
PEAK_RADIUS = 2


def answer(net, cfg, flip_pairs, image, boxes, n_max: int):
    """``image`` [H, W, 3] uint8 on the device, ``boxes`` [[x, y, w, h], ...]
    -> dict of [n, K] tensors: ``coords`` [n, K, 2] in source pixels,
    ``peak``, ``runner_up`` (the highest heat farther than PEAK_RADIUS from
    the argmax), ``offset`` [n, K, 2] (DARK's step, heatmap pixels),
    ``interior`` and ``px`` [n] (source pixels a heatmap pixel spans in x)."""
    m = cfg["MODEL"]
    iw, ih = m["IMAGE_SIZE"]
    hw, hh = m["HEATMAP_SIZE"]
    img_h, img_w = image.shape[:2]
    mask_inv = invert(whole_image_affine(img_w, img_h, 0.0, iw, ih))
    parts = []
    for j in range(0, len(boxes), n_max):
        row = boxes[j:j + n_max]
        meta = [box_center_scale(b, (iw, ih)) for b in row]
        dev = image.device
        inv = torch.tensor(np.stack([affine_transform(c, s, 0.0, (iw, ih), inv=True)
                                     for c, s in meta]), dtype=torch.float32, device=dev)
        ramps = torch.tensor(np.stack([box_ramp(b, img_w, img_h) for b in row]),
                             dtype=torch.float32, device=dev)
        minv = torch.tensor(np.tile(mask_inv, (len(row), 1, 1)), dtype=torch.float32, device=dev)
        x = crops(image, inv, iw, ih)[None]
        pm = box_masks(ramps, minv, iw, ih)[None]
        valid = torch.ones(1, len(row), dtype=torch.bool, device=dev)
        heat = net(x, pm, valid)[0]
        heat_f = net(x.flip(-2), pm.flip(-2), valid)[0]
        heat = (heat + flip_back(heat_f, flip_pairs)) * 0.5
        dec = decode(heat, [c for c, _ in meta], [s for _, s in meta])
        ax = dec["argmax"]
        ys = torch.arange(hh, device=dev)[:, None]
        xs = torch.arange(hw, device=dev)[None, :]
        near = (((xs - ax[..., 0, None, None]).abs() <= PEAK_RADIUS)
                & ((ys - ax[..., 1, None, None]).abs() <= PEAK_RADIUS))
        dec["runner_up"] = heat.masked_fill(near, -float("inf")).amax((-2, -1))
        dec["px"] = torch.tensor([s[0] * 200.0 / hw for _, s in meta], device=dev)
        parts.append(dec)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
