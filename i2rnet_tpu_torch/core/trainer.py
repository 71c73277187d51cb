"""The training loop: epochs, steps, logging, checkpoints, AUTO_RESUME.

Port of ``i2rnet_tpu/core/trainer.py::train_loop`` (reference
``tools/ddp_train.py:101-263``) on one device. The model of ``MODEL.NAME``
(``build_model``: the vanilla or the HRFormer two-stage I²R-Net) is built
from the config and initialised as the JAX package initialises it
(``init_weights``, seed ``SEED``); pretrained weights (``MODEL.PRETRAINED``,
the two-stage recipes' ``SINGLE_MODEL``) wait until such files are in the
repository. Each epoch runs its steps, logs as
the JAX trainer does every ``PRINT_FREQ`` steps, halts on a non-finite loss
(``FloatingPointError``), and writes a checkpoint; the newest checkpoint is
resumed under ``AUTO_RESUME``; the final state is written at the end.

Given a validation dataset, each epoch ends with ``core/validate.py::
validate`` (COCO AP), whose AP is the checkpoint's ``perf`` and picks
``model_best.pth``; without one, ``perf`` is -1. Not here yet: the training
data reader (``batches`` takes its place, below; ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from i2rnet_tpu_torch.core.train import make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.presets import COCO_JOINTS_WEIGHT
from i2rnet_tpu_torch.utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                               save_checkpoint, save_final_state)

logger = logging.getLogger(__name__)

_RAW_DTYPES = {"images": torch.uint8, "person_valid": torch.bool}


class AverageMeter:
    """Running average (reference ``lib/core/function.py``)."""

    def __init__(self):
        self.val, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def raw_to_device(raw: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A raw host batch (numpy, ``device_preprocess``'s contract) on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=_RAW_DTYPES.get(k, torch.float32)).to(device)
            for k, v in raw.items()}


def joints_weight_for(cfg: Dict):
    """``LOSS.USE_DIFFERENT_JOINTS_WEIGHT``: the dataset's limb weights, or None."""
    k = cfg["MODEL"]["NUM_JOINTS"]
    if cfg["LOSS"]["USE_DIFFERENT_JOINTS_WEIGHT"] and len(COCO_JOINTS_WEIGHT) == k:
        return COCO_JOINTS_WEIGHT
    return None


def _record(metrics, loss_m, acc_m, epoch, i):
    lv = float(metrics["loss"])
    if not math.isfinite(lv):
        # halt before a non-finite loss reaches the checkpoint chain
        raise FloatingPointError(f"non-finite loss {lv} at epoch {epoch} step {i}")
    loss_m.update(lv)
    acc_m.update(float(metrics["acc"]))


def train_loop(cfg: Dict, output_dir: str, batches: Callable[[int], Iterable[Dict]],
               max_epochs: Optional[int] = None, max_steps_per_epoch: Optional[int] = None,
               device="cuda", on_step: Optional[Callable[[int, int, Dict], None]] = None,
               val_dataset=None) -> TrainState:
    """Train the model of ``cfg`` on ``device``; returns the final TrainState.

    ``batches(epoch)`` yields the epoch's raw host batches (numpy dicts in
    ``device_preprocess``'s contract: images, crop_affines, boxes,
    mask_affines, joints_hm, joints_vis, person_valid), in place of the JAX
    trainer's ``train_batches`` + ``make_raw_batch`` until the dataset reader
    is ported. The schedule's steps per epoch are ``max_steps_per_epoch`` when
    given, else ``len(batches(epoch))``. ``on_step(epoch, i, metrics)``, when
    given, sees each step's metrics (device tensors). ``val_dataset`` (a
    ``data/coco.py::COCODataset``), when given, is validated after every
    epoch into ``output_dir``; its AP is the epoch's ``perf``.
    """
    m = cfg["MODEL"]
    # initialised on the CPU from a CPU generator (the same weights on any
    # device), then moved
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg["SEED"]))
    model.to(device)

    begin_epoch = cfg["TRAIN"]["BEGIN_EPOCH"]
    steps_per_epoch = max_steps_per_epoch or len(batches(begin_epoch))
    optimizer, schedule = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    state = TrainState(model, optimizer, schedule)

    best_perf = -1.0
    if cfg["AUTO_RESUME"]:
        ckpt = latest_checkpoint(output_dir)
        if ckpt:
            payload = load_checkpoint(ckpt)
            model.load_state_dict(payload["state_dict"])
            optimizer.load_state_dict(payload["optimizer"])
            state.step = payload["step"]
            begin_epoch = payload["epoch"] + 1
            best_perf = payload["perf"]
            logger.info("=> auto-resumed from %s (epoch %d)", ckpt, begin_epoch)

    loss_cfg = cfg["LOSS"]
    step_fn = make_train_step(state, loss_weights=m["LOSS_WEIGHTS"],
                              use_target_weight=loss_cfg["USE_TARGET_WEIGHT"],
                              use_ohkm=loss_cfg["USE_OHKM"], topk=loss_cfg["TOPK"])
    prep = dict(image_size=tuple(m["IMAGE_SIZE"]), heatmap_size=tuple(m["HEATMAP_SIZE"]),
                sigma=m["SIGMA"], joints_weight=joints_weight_for(cfg))
    generator = torch.Generator().manual_seed(cfg["SEED"] + 1)
    end_epoch = max_epochs if max_epochs is not None else cfg["TRAIN"]["END_EPOCH"]
    global_step = state.step
    print_freq = cfg["PRINT_FREQ"]

    for epoch in range(begin_epoch, end_epoch):
        loss_m, acc_m, batch_t = AverageMeter(), AverageMeter(), AverageMeter()
        pending = []
        t0 = time.time()
        for i, raw in enumerate(batches(epoch)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            batch = device_preprocess(raw_to_device(raw, device), **prep)
            metrics = step_fn(batch, generator)
            pending.append(metrics)
            if on_step is not None:
                on_step(epoch, i, metrics)
            batch_t.update(time.time() - t0)
            t0 = time.time()
            global_step += 1
            if i % print_freq == 0:
                for mt in pending:
                    _record(mt, loss_m, acc_m, epoch, i)
                pending.clear()
                logger.info("Epoch [%d][%d/%d] time %.3fs loss %.5f (%.5f) acc %.3f (%.3f) "
                            "lr %.2e", epoch, i, steps_per_epoch, batch_t.avg, loss_m.val,
                            loss_m.avg, acc_m.val, acc_m.avg, schedule(state.step))
        for mt in pending:  # metrics deferred past the last print
            _record(mt, loss_m, acc_m, epoch, i)
        pending.clear()

        perf = -1.0
        if val_dataset is not None:
            name_value, perf = validate(cfg, val_dataset, model, output_dir, device=device)
            logger.info("=> epoch %d validation: %s", epoch,
                        ", ".join(f"{k} {v:.4f}" for k, v in name_value.items()))
        is_best = perf > best_perf
        best_perf = max(best_perf, perf)
        save_checkpoint(output_dir, epoch, state, perf, is_best, model_name=m["NAME"],
                        train_global_steps=global_step)
        logger.info("=> epoch %d done, loss %.5f, perf %.4f (best %.4f)", epoch, loss_m.avg,
                    perf, best_perf)

    save_final_state(output_dir, state)
    return state
