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

With ``DEBUG.DEBUG`` the step returns the full heatmaps (forward and flip
test, ``serving.heatmap_program``), decoded on the device as the fused step
decodes them, and every ``PRINT_FREQ``-th batch is dumped as images
(``utils/vis.py::save_debug_images``: the crops with their GT joints, GT and
predicted heatmaps) under ``<output_dir>/debug/val_<batch>``, as the JAX
``validate`` does (``i2rnet_tpu/core/validate.py:55-60,160-174``).

Across processes (a process group of more than one rank,
``parallel/dist.py``; the JAX ``validate`` over a mesh, ``i2rnet_tpu/core/
validate.py:42-53,127-152``): the global eval batch is
``TEST.BATCH_SIZE_PER_GPU`` times the world size, every rank walks the same
global batches and assembles and runs its contiguous block of their rows,
and each batch's keypoints, boxes and image ids are gathered in global order,
so every rank scores the whole result set, into its own ``proc<rank>``
directory, and returns the same ``name_value`` and ``perf``. The debug
dumps are written in a world of one only, as the JAX ``validate`` writes
them.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from i2rnet_tpu_torch.data.prefetch import prefetch_batches
from i2rnet_tpu_torch.ops.decode import get_final_preds
from i2rnet_tpu_torch.parallel import dist
from i2rnet_tpu_torch.serving import heatmap_program, make_eval_fn
from i2rnet_tpu_torch.utils.vis import save_debug_images

logger = logging.getLogger(__name__)


def debug_meta(raw, image_size, heatmap_size) -> Dict:
    """The GT joints of a raw batch in crop pixels, and their visibility, as
    ``save_debug_images`` takes them; sizes are (width, height)."""
    scale = np.array([image_size[0] / heatmap_size[0], image_size[1] / heatmap_size[1]],
                     np.float32)
    return {"joints": np.asarray(raw["joints_hm"]) * scale,
            "joints_vis": np.asarray(raw["joints_vis"])[..., None]}


def validate(cfg: Dict, dataset, model, output_dir: str,
             eval_step_fn: Optional[Callable] = None, main_target: Optional[bool] = None,
             mesh=None, device=None, max_batches: Optional[int] = None):
    """Run the full evaluation in batches of ``TEST.BATCH_SIZE_PER_GPU``
    images a rank (module docstring); returns ``(name_value, perf)``.

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
    ``max_batches`` stops after that many batches and scores what they gave
    (``tools/test.py --max-batches``).
    """
    if mesh is not None:
        raise NotImplementedError("validate over a device mesh is not ported: the port runs "
                                  "one device a process, data-parallel across processes "
                                  "(parallel/dist.py; ROADMAP queue 1, item 6)")
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
    rows = test["BATCH_SIZE_PER_GPU"]  # this rank's rows of each global batch
    world, rank = dist.world_size(), dist.rank()
    batch_images = rows * world
    output_dir = dist.proc_dir(output_dir)
    heatmap_size = (dataset.heatmap_width, dataset.heatmap_height)
    # the fused program: forward, flip forward, DARK decode. TEST.SHIFT_HEATMAP
    # is not applied: the reference's validate() never applies the HRNet 1px
    # shift (lib/core/function.py:142-162)
    debug = bool(cfg["DEBUG"]["DEBUG"]) and world == 1
    if eval_step_fn is None and debug:
        # the dumps need the full heatmaps on the host: the heatmaps-out step
        # (reference function.py:240-241), decoded as the fused step decodes
        heatmaps = torch.inference_mode()(heatmap_program(cfg, model, dataset.flip_pairs))

        def eval_step_fn(_model, batch):
            return heatmaps(batch["images"], batch["pos_masks"], batch["person_valid"])
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
        boxes = np.stack([centers[sel, 0], centers[sel, 1], scales[sel, 0], scales[sel, 1],
                          area[sel], scores[sel]], axis=1)
        # every rank's part of the global batch, in rank (row) order
        for p, bx, ids in dist.gather_host((preds[sel], boxes, image_ids[sel])):
            all_preds.append(p)
            all_boxes.append(bx)
            all_image_ids.extend(ids.tolist())
            persons_done += len(ids)

    def assemble(_idx, items, n_bucket):
        # pad a trailing partial batch so the (B, N) shape stays the same;
        # padded rows are marked invalid so they never reach the evaluator;
        # this rank takes its contiguous block of the global batch's rows
        n_real = len(items)
        if n_real < batch_images:
            items = list(items) + [items[-1]] * (batch_images - n_real)
        lo = rank * rows
        raw, meta = dataset.make_raw_batch(items[lo:lo + rows], n_bucket)
        if n_real < lo + rows:
            raw["person_valid"][max(n_real - lo, 0):] = False
        return raw, meta

    workers = max(0, cfg.get("WORKERS", 0))
    batch_iter = prefetch_batches(batches, assemble, num_workers=workers)
    for i, (raw, meta) in enumerate(batch_iter):
        if max_batches is not None and i >= max_batches:
            break
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
            if debug and i % max(cfg["PRINT_FREQ"], 1) == 0:
                debug_dir = os.path.join(output_dir, "debug")
                os.makedirs(debug_dir, exist_ok=True)
                meta_dbg = debug_meta(raw, (dataset.image_width, dataset.image_height),
                                      heatmap_size)
                save_debug_images(cfg, batch, meta_dbg, batch["target"], heat,
                                  os.path.join(debug_dir, f"val_{i}"))
        entry = (coords, maxvals, raw["person_valid"].reshape(b * n),
                 centers, scales, meta["score"].reshape(b * n),
                 meta["image_id"].reshape(b * n), n)
        in_flight.append(entry)
        if len(in_flight) > pipeline_depth:
            finish(in_flight.pop(0))

    if hasattr(batch_iter, "close"):  # stop the threads left ahead of the loop
        batch_iter.close()
    for entry in in_flight:
        finish(entry)
    dt = time.time() - t0
    logger.info("validate: %d persons in %.1fs (%.1f persons/s incl. host IO)",
                persons_done, dt, persons_done / max(dt, 1e-9))

    all_preds = np.concatenate(all_preds, axis=0)
    all_boxes = np.concatenate(all_boxes, axis=0)
    return dataset.evaluate(cfg, all_preds, output_dir, all_boxes, all_image_ids)
