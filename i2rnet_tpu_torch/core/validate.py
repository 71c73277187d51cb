"""Evaluation loop: model forward and flip test, DARK decode on the device, COCO AP.

Port of ``i2rnet_tpu/core/validate.py`` (reference ``lib/core/function.py:
105-287``, ``validate``). Host batches from the dataset (``make_raw_batch``,
assembled ahead by worker threads) are preprocessed on the device; the model
runs twice (flip test) and decodes there (``serving.make_eval_fn``), so only
``[P, K, 2]`` keypoints and ``[P, K, 1]`` confidences come back to the host.
Accumulation mirrors the reference's buffers: all_preds [M, K, 3] (x, y,
conf) and all_boxes [M, 6] (center, scale, area = prod(scale * 200), score)
over the valid persons of every batch; the dataset's ``evaluate`` rescores,
suppresses, writes the results JSON and scores it.

Not ported: validation over a mesh or across processes (ROADMAP queue 1,
item 8) and the ``DEBUG.DEBUG`` image dumps (queue 1, item 7); each raises.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from i2rnet_tpu_torch.data.prefetch import prefetch_batches
from i2rnet_tpu_torch.ops.decode import get_final_preds
from i2rnet_tpu_torch.serving import make_eval_fn

logger = logging.getLogger(__name__)


def _refuse_unported(cfg: Dict, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("validate over a device mesh is not ported: ROADMAP queue 1, "
                                  "item 8")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("validate across processes is not ported: ROADMAP queue 1, "
                                  "item 8")
    if cfg.get("DEBUG", {}).get("DEBUG", False):
        raise NotImplementedError("DEBUG.DEBUG image dumps are not ported: ROADMAP queue 1, "
                                  "item 7")


def validate(cfg: Dict, dataset, model, output_dir: str,
             eval_step_fn: Optional[Callable] = None, main_target: Optional[bool] = None,
             mesh=None, device=None):
    """Run the full evaluation in batches of ``TEST.BATCH_SIZE_PER_GPU``
    images; returns ``(name_value, perf)``.

    ``eval_step_fn(model, batch) -> heatmaps [B, N, K, h, w]`` may be
    injected (tests use an oracle that returns the GT heatmaps, to check the
    decode and evaluation path); its maps are decoded on the device by
    ``ops/decode.py::get_final_preds``.

    ``main_target`` replicates reference ``validate_main_target``
    (``lib/core/function.py:289-468``): each batch item is one target person
    plus its nearest neighbors, and only the target (person index 0) is
    scored. It defaults to ``DATASET.PATCH_MODE == "main_target"``.

    ``device``: where the batches and the model run; the model's device by
    default, else CUDA. ``DEVICE.EVAL_PIPELINE`` batches' outputs stay on
    the device before they are copied back, so the host assembles the next
    batch while the card runs this one (0: copy each batch back at once).
    """
    _refuse_unported(cfg, mesh)
    if main_target is None:
        main_target = cfg["DATASET"]["PATCH_MODE"] == "main_target"
    if model is None:
        device = torch.device(device or "cuda")
    else:
        on = next(model.parameters()).device
        device = on if device is None else torch.empty(0, device=device).device
        if device != on:
            raise ValueError(f"the model is on {on}, validate was asked for {device}")
    test = cfg["TEST"]
    batch_images = test["BATCH_SIZE_PER_GPU"]
    heatmap_size = (dataset.heatmap_width, dataset.heatmap_height)
    # the fused program: forward, flip forward, DARK decode. TEST.SHIFT_HEATMAP
    # is not applied: the reference's validate() never applies the HRNet 1px
    # shift (lib/core/function.py:142-162)
    evaluate = make_eval_fn(cfg, model, dataset.flip_pairs) if eval_step_fn is None else None

    @torch.inference_mode()
    def decode(heat, centers, scales):
        b, n, k, h, w = heat.shape
        return get_final_preds(heat.reshape(b * n, k, h, w).float(), centers, scales,
                               blur_kernel=int(test["BLUR_KERNEL"]), heatmap_size=heatmap_size,
                               post_process=bool(test["POST_PROCESS"]))

    all_preds, all_boxes, all_image_ids = [], [], []
    t0 = time.time()
    persons_done = 0
    batches = (dataset.eval_batches_main_target(batch_images) if main_target
               else dataset.eval_batches(batch_images))
    pipeline_depth = max(0, int(cfg["DEVICE"]["EVAL_PIPELINE"]))
    in_flight: list = []

    def finish(entry):
        nonlocal persons_done
        coords, maxvals, valid, centers, scales, scores, image_ids, n = entry
        coords = coords.cpu().numpy()
        maxvals = maxvals.cpu().numpy()
        area = np.prod(scales * 200.0, axis=1)
        if main_target:
            # only the target person (index 0 of each item) is scored
            target_only = np.zeros_like(valid)
            target_only[0::n] = valid[0::n]
            valid = target_only
        sel = np.nonzero(valid)[0]
        preds = np.concatenate([coords, maxvals], axis=2)  # [b*n, K, 3]
        all_preds.append(preds[sel])
        all_boxes.append(np.stack([
            centers[sel, 0], centers[sel, 1],
            scales[sel, 0], scales[sel, 1],
            area[sel], scores[sel],
        ], axis=1))
        all_image_ids.extend(image_ids[sel].tolist())
        persons_done += len(sel)

    def assemble(_idx, items, n_bucket):
        # pad a trailing partial batch so the (B, N) shape stays the same;
        # padded rows are marked invalid so they never reach the evaluator
        n_real = len(items)
        if n_real < batch_images:
            items = list(items) + [items[-1]] * (batch_images - n_real)
        raw, meta = dataset.make_raw_batch(items, n_bucket)
        if n_real < batch_images:
            raw["person_valid"][n_real:] = False
        return raw, meta

    workers = max(0, cfg.get("WORKERS", 0))
    for raw, meta in prefetch_batches(batches, assemble, num_workers=workers):
        batch = dataset.device_batch(raw, device)
        b, n = raw["person_valid"].shape
        centers = meta["center"].reshape(b * n, 2)
        scales = meta["scale"].reshape(b * n, 2)
        centers_d = torch.from_numpy(centers).to(device)
        scales_d = torch.from_numpy(scales).to(device)
        if evaluate is not None:
            coords, maxvals = evaluate(batch["images"], batch["pos_masks"],
                                       batch["person_valid"], centers_d, scales_d)
        else:
            heat = torch.as_tensor(eval_step_fn(model, batch), device=device)
            coords, maxvals = decode(heat, centers_d, scales_d)
        entry = (coords, maxvals, raw["person_valid"].reshape(b * n),
                 centers, scales, meta["score"].reshape(b * n),
                 meta["image_id"].reshape(b * n), n)
        in_flight.append(entry)
        if len(in_flight) > pipeline_depth:
            finish(in_flight.pop(0))

    for entry in in_flight:
        finish(entry)
    dt = time.time() - t0
    logger.info("validate: %d persons in %.1fs (%.1f persons/s incl. host IO)",
                persons_done, dt, persons_done / max(dt, 1e-9))

    all_preds = np.concatenate(all_preds, axis=0)
    all_boxes = np.concatenate(all_boxes, axis=0)
    return dataset.evaluate(cfg, all_preds, output_dir, all_boxes, all_image_ids)
