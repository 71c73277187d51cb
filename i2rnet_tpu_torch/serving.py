"""In-process serving: preprocess -> forward (+ flip test) -> DARK decode.

Port of ``i2rnet_tpu/serving.py``: :func:`boxes_to_person_meta` (host request
math, copied), :func:`make_serve_fn` (the device program: crop-warp and
position masks, then :func:`make_eval_fn` -- the model forward, a second
forward on the flipped crops, decode with the inverse affine, padded persons
zeroed) and :class:`Predictor`
(pads requests into static ``(B, N)`` person buckets, chunks what does not
fit, routes each row to the smallest bucket that holds it). The predictor is
built from a model and its weights; exporting an artifact and the
``MicroBatcher`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from i2rnet_tpu_torch.ops.decode import get_final_preds
from i2rnet_tpu_torch.ops.flip import flip_back
from i2rnet_tpu_torch.ops.preprocess import np_rotate_bound_resize_affine, preprocess_inputs
from i2rnet_tpu_torch.ops.transforms import np_get_affine_transform


def boxes_to_person_meta(boxes: Sequence[Sequence[float]],
                         image_size: Tuple[int, int],
                         scale_factor: float = 1.25):
    """Person boxes (x, y, w, h) -> (centers [n,2], scales [n,2],
    crop_affines [n,2,3], rects [n,4] x1y1x2y2 ramp bounds), as
    ``i2rnet_tpu/serving.py:42`` (reference ``lib/dataset/coco.py:175-196``)."""
    iw, ih = int(image_size[0]), int(image_size[1])
    aspect = iw / ih
    centers, scales, affines, rects = [], [], [], []
    for x, y, w, h in boxes:
        c = np.array([x + (w - 1) / 2, y + (h - 1) / 2], np.float32)
        x1i, y1i = np.trunc(x), np.trunc(y)
        x2i, y2i = np.trunc(x + w), np.trunc(y + h)
        rects.append([x1i - 1, y1i - 1, x2i + 1, y2i + 1])
        if w > aspect * h:
            h = w / aspect
        else:
            w = h * aspect
        s = np.array([w / 200.0, h / 200.0], np.float32) * scale_factor
        centers.append(c)
        scales.append(s)
        affines.append(np_get_affine_transform(c, s, 0.0, (iw, ih)))
    return (np.asarray(centers, np.float32), np.asarray(scales, np.float32),
            np.asarray(affines, np.float32), np.asarray(rects, np.float32))


def make_eval_fn(cfg: Dict, model, flip_pairs):
    """Returns ``evaluate(crops, pos_masks, person_valid, centers, scales) ->
    (coords [B*N,K,2], maxvals [B*N,K,1])``: the eval protocol of
    ``core/train.py::make_eval_step`` -- the forward, a second forward on the
    flipped crops averaged in (reference ``lib/core/function.py:142-162``,
    without the HRNet 1px shift, as validate() never applies it), DARK decode
    to source pixels, padded persons zeroed. A model that returns a dict
    (the two-stage ``interformer``) is read at ``["multi"]``, as
    ``i2rnet_tpu/serving.py:120-124``."""
    heatmap_size = tuple(int(v) for v in cfg["MODEL"]["HEATMAP_SIZE"])
    test = cfg["TEST"]

    def forward(*args):
        out = model(*args)
        # the two-stage model's {"single", "multi"}: serve the inter stage's
        return out["multi"] if isinstance(out, dict) else out

    @torch.inference_mode()
    def evaluate(crops, pos_masks, person_valid, centers, scales):
        heat = forward(crops, pos_masks, person_valid)
        if test["FLIP_TEST"]:
            heat_f = forward(crops.flip(-2), pos_masks.flip(-2), person_valid)
            heat = (heat + flip_back(heat_f, flip_pairs or [])) * 0.5
        b, n = heat.shape[:2]
        coords, maxvals = get_final_preds(
            heat.reshape(b * n, *heat.shape[2:]), centers, scales,
            blur_kernel=int(test["BLUR_KERNEL"]), heatmap_size=heatmap_size,
            post_process=bool(test["POST_PROCESS"]))
        vmask = person_valid.reshape(b * n, 1, 1).float()
        return coords * vmask, maxvals * vmask

    return evaluate


def make_serve_fn(cfg: Dict, model, flip_pairs):
    """Returns ``serve(images_u8, crop_affines, boxes, mask_affines,
    person_valid, centers, scales) -> (coords [B*N,K,2], maxvals [B*N,K,1])``
    over tensors on the model's device: the crop-warp and position masks of
    ``preprocess_inputs``, then :func:`make_eval_fn`'s program.

    Invalid person slots must carry non-singular (e.g. identity) affines: a
    zero matrix inverts to nan, and attention would carry the nan crop into
    the image's valid persons.
    """
    image_size = tuple(int(v) for v in cfg["MODEL"]["IMAGE_SIZE"])
    evaluate = make_eval_fn(cfg, model, flip_pairs)

    @torch.inference_mode()
    def serve(images_u8, crop_affines, boxes, mask_affines, person_valid, centers, scales):
        # serving affines come from boxes and never rotate: the axis-aligned warp
        crops, pos_masks = preprocess_inputs(images_u8, crop_affines, boxes, mask_affines,
                                             image_size, axis_aligned=True)
        return evaluate(crops, pos_masks, person_valid, centers, scales)

    return serve


class Predictor:
    """``predict(images, boxes_per_image)``: raw uint8 RGB images up to the
    ``raw_hw`` canvas plus per-image person boxes (x, y, w, h) -> one
    ``[n_i, K, 3]`` array (x, y, confidence in source pixels) per image.

    Each image's boxes are split into rows of at most ``max(n_buckets)``
    persons; each row goes to the smallest person bucket that holds it and
    runs in a static ``[batch_images, n]`` batch padded with invalid rows.
    """

    def __init__(self, model, cfg: Dict, flip_pairs, batch_images: int = 8,
                 n_buckets: Sequence[int] = (2, 4, 7), raw_hw: Tuple[int, int] = (480, 640)):
        self.device = next(model.parameters()).device
        self.serve = make_serve_fn(cfg, model, flip_pairs)
        self.image_size = tuple(int(v) for v in cfg["MODEL"]["IMAGE_SIZE"])
        self.num_joints = int(cfg["MODEL"]["NUM_JOINTS"])
        self.batch_images = int(batch_images)
        self.n_buckets = sorted({int(n) for n in n_buckets})
        self.raw_hw = (int(raw_hw[0]), int(raw_hw[1]))

    def _bucket(self, m: int) -> int:
        return next(n for n in self.n_buckets if m <= n)

    def _run(self, n: int, chunk) -> np.ndarray:
        """One static (B, n) call over ``chunk`` rows -> [B, n, K, 3] keypoints."""
        b, (rh, rw) = self.batch_images, self.raw_hw
        imgs = np.zeros((b, rh, rw, 3), np.uint8)
        # padded slots get IDENTITY affines: a zero affine's inverse is nan
        affs = np.zeros((b, n, 2, 3), np.float32)
        affs[..., 0, 0] = affs[..., 1, 1] = 1.0
        mask_affs = affs.copy()
        rects = np.zeros((b, n, 4), np.float32)
        valid = np.zeros((b, n), bool)
        cent = np.zeros((b * n, 2), np.float32)
        scal = np.ones((b * n, 2), np.float32)
        for r, (_, _, img, bxs) in enumerate(chunk):
            ih, iw = img.shape[:2]
            imgs[r, :ih, :iw] = img
            c, s, a, rect = boxes_to_person_meta(bxs, self.image_size)
            m = len(bxs)
            affs[r, :m] = a
            # position mask: the full image squeezed to the model input, with
            # the ramp bounds saturated where a box touches the border
            mask_affs[r, :] = np_rotate_bound_resize_affine(iw, ih, 0.0, *self.image_size)
            rect[:, 0] = np.where(rect[:, 0] <= -1, -1e9, rect[:, 0])
            rect[:, 1] = np.where(rect[:, 1] <= -1, -1e9, rect[:, 1])
            rect[:, 2] = np.where(rect[:, 2] >= iw, 1e9, rect[:, 2])
            rect[:, 3] = np.where(rect[:, 3] >= ih, 1e9, rect[:, 3])
            rects[r, :m] = rect
            valid[r, :m] = True
            cent[r * n:r * n + m] = c
            scal[r * n:r * n + m] = s
        args = [torch.from_numpy(a).to(self.device, non_blocking=True)
                for a in (imgs, affs, rects, mask_affs, valid, cent, scal)]
        coords, maxvals = self.serve(*args)
        kp = torch.cat([coords, maxvals], dim=-1).cpu().numpy()
        return kp.reshape(b, n, self.num_joints, 3)

    def predict(self, images: Sequence[np.ndarray],
                boxes_per_image: Sequence[Sequence[Sequence[float]]]) -> List[np.ndarray]:
        if len(images) != len(boxes_per_image):
            raise ValueError("images and boxes_per_image length mismatch")
        rh, rw = self.raw_hw
        n_max = self.n_buckets[-1]
        rows_by_n: Dict[int, list] = {n: [] for n in self.n_buckets}
        for i, (img, bxs) in enumerate(zip(images, boxes_per_image)):
            img = np.asarray(img)
            if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
                raise ValueError(f"image {i}: expected uint8 HxWx3, got {img.dtype} {img.shape}")
            if img.shape[0] > rh or img.shape[1] > rw:
                raise ValueError(f"image {i}: {img.shape[:2]} exceeds the canvas {(rh, rw)}")
            bxs = list(bxs) or [[0, 0, img.shape[1], img.shape[0]]]
            for j in range(0, len(bxs), n_max):
                part = bxs[j:j + n_max]
                rows_by_n[self._bucket(len(part))].append((i, j, img, part))

        parts: Dict[int, list] = {}
        for n, rows in rows_by_n.items():
            for j0 in range(0, len(rows), self.batch_images):
                chunk = rows[j0:j0 + self.batch_images]
                kp = self._run(n, chunk)
                for r, (i, start, _, bxs) in enumerate(chunk):
                    parts.setdefault(i, []).append((start, kp[r, :len(bxs)]))
        return [np.concatenate([k for _, k in sorted(parts[i], key=lambda t: t[0])], axis=0)
                for i in range(len(images))]
