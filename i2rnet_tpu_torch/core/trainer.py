"""The training loop: epochs, steps, logging, checkpoints, AUTO_RESUME.

Port of ``i2rnet_tpu/core/trainer.py::train_loop`` (reference
``tools/ddp_train.py:101-263``), on one device a process. The model of ``MODEL.NAME``
(``build_model``: the vanilla or the HRFormer two-stage I²R-Net) is built
from the config and initialised as the JAX package initialises it
(``init_weights``, seed ``SEED``), then takes its pretrained weights as the
JAX trainer does (``core/pretrained.py::load_pretrained``: a two-stage
recipe's ``SINGLE_MODEL`` into its first stage, ``PRETRAINED`` under
``INIT_WEIGHTS``) and freezes what ``SINGLEFORMER_FIX`` and
``BACKBONE_FIX`` name; the optimizer gets the trainable parameters only.
Each epoch runs its steps, logs as
the JAX trainer does every ``PRINT_FREQ`` steps, halts on a non-finite loss
(``FloatingPointError``), and writes a checkpoint; the newest checkpoint is
resumed under ``AUTO_RESUME``; the final state is written at the end.

Without ``batches`` the loop trains from the dataset ``cfg`` names, as the
JAX trainer does: ``DATASET.DATASET`` through ``registry.py``, its
``TRAIN_SET`` read with ``is_train`` and its ``TEST_SET`` validated; each
epoch's order and patch choices from ``RandomState(SEED + 1000 + epoch)``,
each batch's augmentation from its own ``RandomState``, batches assembled
ahead by ``WORKERS`` threads (``data/prefetch.py``) and preprocessed on the
device by the dataset. ``batches`` (synthetic raw batches) takes the
dataset's place where given.

With a validation dataset, every ``validate_every``-th epoch ends with
``core/validate.py::validate`` (the dataset's AP), whose AP is the
checkpoint's ``perf`` and picks ``model_best.pth``; without one, ``perf``
is -1. Each process (rank) takes ``TRAIN.BATCH_SIZE_PER_GPU`` images a step.

The step recomputes activations as ``DEVICE.REMAT`` says (``core/train.py``).
With ``DEBUG.DEBUG`` every logged step (each ``PRINT_FREQ``-th) dumps its
batch as images (``utils/vis.py::save_debug_images``: the crops with their GT
joints, GT and predicted heatmaps) under ``<output_dir>/debug/
train_<epoch>_<step>``, as the JAX trainer does
(``i2rnet_tpu/core/trainer.py:168-185``).

Across processes (a process group of more than one rank,
``parallel/dist.py``; the JAX trainer's mesh, ``i2rnet_tpu/core/trainer.py:
43-47,113,127-133``): the global batch is ``TRAIN.BATCH_SIZE_PER_GPU`` times
the world size, and each rank takes ``BATCH_SIZE_PER_GPU`` images a step,
its interleaved shard of the epoch's order (``train_batches(...,
shard_index=rank, num_shards=world)``) with the JAX trainer's per-batch
seeds. The shards' batch counts can differ (an image holds a variable
number of items under ``main_target`` and ``window``, and the last partial
batch is padded on one shard and not another), so every rank takes the
fewest batches of any shard that epoch, and no rank waits alone in a
collective. Rank 0's initial (or resumed) parameters and buffers are broadcast to
every rank before the first step, and checked equal at each epoch's end. The step sums
the gradients over the ranks (``core/train.py``); validation runs across the
ranks (``core/validate.py``); only rank 0 writes checkpoints, the final
state and the debug dumps, and every rank waits for it at a barrier after
each. ``AUTO_RESUME`` loads on every rank. With ``batches``, each rank's
callable yields that rank's rows, the same number of batches on every rank.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from i2rnet_tpu_torch.core.pretrained import freeze, load_pretrained
from i2rnet_tpu_torch.core.train import make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.validate import debug_meta, validate
from i2rnet_tpu_torch.data.prefetch import prefetch_batches
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.parallel import dist
from i2rnet_tpu_torch.registry import get_dataset_class
from i2rnet_tpu_torch.utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                               save_checkpoint, save_final_state)
from i2rnet_tpu_torch.utils.vis import save_debug_images

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
    """``LOSS.USE_DIFFERENT_JOINTS_WEIGHT``: the limb weights of the dataset
    ``DATASET.DATASET`` names, where it has one weight a joint; else None (a
    name outside the registry, such as the tiny configs' ``synthetic``, has
    none)."""
    if not cfg["LOSS"]["USE_DIFFERENT_JOINTS_WEIGHT"]:
        return None
    try:
        weights = tuple(get_dataset_class(cfg["DATASET"]["DATASET"]).joints_weight)
    except KeyError:
        return None
    return weights if len(weights) == cfg["MODEL"]["NUM_JOINTS"] else None


def epoch_plan(cfg: Dict, dataset, epoch: int, batch_images: int, shard_index: int = 0,
               num_shards: int = 1) -> List[Tuple]:
    """One epoch's ``(items, n_bucket)`` batches of ``train_batches``, in the
    order and with the patch choices that ``RandomState(SEED + 1000 +
    epoch)`` gives, as the JAX trainer draws them
    (``i2rnet_tpu/core/trainer.py:114-130``). ``batch_images`` is this
    process's share of the global batch and ``shard_index`` of
    ``num_shards`` its shard of the order (a rank's)."""
    return list(dataset.train_batches(batch_images,
                                      np.random.RandomState(cfg["SEED"] + 1000 + epoch),
                                      shard_index=shard_index, num_shards=num_shards))


def assemble_batches(cfg: Dict, dataset, epoch: int, plan: Iterable[Tuple]) -> Iterable[Dict]:
    """The raw batches of ``plan`` (:func:`epoch_plan`), each augmented from
    ``RandomState((SEED + 1) * 100003 + epoch * 10007 + index)`` as the JAX
    trainer does, assembled ahead by ``WORKERS`` threads."""
    seed = cfg["SEED"]

    def make_batch(idx, items, nb):
        rng = np.random.RandomState((seed + 1) * 100003 + epoch * 10007 + idx)
        raw, _ = dataset.make_raw_batch(items, nb, rng)
        return raw

    return prefetch_batches(iter(plan), make_batch, num_workers=max(0, cfg["WORKERS"]))


def epoch_batches(cfg: Dict, dataset, epoch: int, batch_images: int, shard_index: int = 0,
                  num_shards: int = 1) -> Iterable[Dict]:
    """One epoch's raw training batches from ``dataset``, composed as the JAX
    trainer composes them: :func:`epoch_plan`'s batches, assembled by
    :func:`assemble_batches`."""
    return assemble_batches(cfg, dataset, epoch,
                            epoch_plan(cfg, dataset, epoch, batch_images, shard_index, num_shards))


def _record(metrics, loss_m, acc_m, epoch, i):
    lv = float(metrics["loss"])
    if not math.isfinite(lv):
        # halt before a non-finite loss reaches the checkpoint chain
        raise FloatingPointError(f"non-finite loss {lv} at epoch {epoch} step {i}")
    loss_m.update(lv)
    acc_m.update(float(metrics["acc"]))


def train_loop(cfg: Dict, output_dir: str,
               batches: Optional[Callable[[int], Iterable[Dict]]] = None,
               max_epochs: Optional[int] = None, max_steps_per_epoch: Optional[int] = None,
               device="cuda", on_step: Optional[Callable[[int, int, Dict], None]] = None,
               val_dataset=None, validate_every: int = 1) -> TrainState:
    """Train the model of ``cfg`` on ``device``; returns the final TrainState.

    Without ``batches`` the batches come from the dataset of ``cfg``
    (``DATASET.DATASET``, ``ROOT``, ``TRAIN_SET``; :func:`epoch_batches`),
    the schedule counting ``max(1, len(dataset) // global batch)`` steps an
    epoch; each epoch runs the fewest batches of any rank's shard (at most
    ``max_steps_per_epoch``), and ``TEST_SET`` is validated unless
    ``val_dataset`` names another. ``batches(epoch)``, where given, yields the
    epoch's raw host batches instead (numpy dicts in ``device_preprocess``'s
    contract: images, crop_affines, boxes, mask_affines, joints_hm,
    joints_vis, person_valid); the schedule's steps per epoch are then
    ``max_steps_per_epoch`` when given, else ``len(batches(epoch))``, and
    only ``val_dataset`` is validated.

    ``on_step(epoch, i, metrics)``, when given, sees each step's metrics
    (device tensors) with two host times in seconds: ``data_time``, the
    wait for the step's batch, and ``batch_time``, the step's whole
    iteration. A validation dataset is validated after every
    ``validate_every``-th epoch into ``output_dir``; its AP is the epoch's
    ``perf``.
    """
    m = cfg["MODEL"]
    begin_epoch = cfg["TRAIN"]["BEGIN_EPOCH"]
    if batches is None:
        d = cfg["DATASET"]
        ds_cls = get_dataset_class(d["DATASET"])
        train_ds = ds_cls(cfg, d["ROOT"], d["TRAIN_SET"], is_train=True)
        if val_dataset is None:
            val_dataset = ds_cls(cfg, d["ROOT"], d["TEST_SET"], is_train=False)
        batch_images = cfg["TRAIN"]["BATCH_SIZE_PER_GPU"]  # this rank's share
        world = dist.world_size()
        steps_per_epoch = max(1, len(train_ds) // (batch_images * world))
        if max_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
        if world > 1:
            logger.info("data parallel: %d ranks, global batch %d images", world,
                        batch_images * world)

        def epoch_data(epoch) -> Tuple[Optional[int], Iterable[Dict]]:
            plan = epoch_plan(cfg, train_ds, epoch, batch_images, dist.rank(), world)
            # every rank takes the fewest batches of any shard
            return min(dist.gather_host(len(plan))), assemble_batches(cfg, train_ds, epoch, plan)

        def to_device(raw):
            return train_ds.device_batch(raw, device)
    else:
        steps_per_epoch = max_steps_per_epoch or len(batches(begin_epoch))

        def epoch_data(epoch) -> Tuple[Optional[int], Iterable[Dict]]:
            return None, batches(epoch)

        prep = dict(image_size=tuple(m["IMAGE_SIZE"]), heatmap_size=tuple(m["HEATMAP_SIZE"]),
                    sigma=m["SIGMA"], joints_weight=joints_weight_for(cfg))

        def to_device(raw):
            return device_preprocess(raw_to_device(raw, device), **prep)

    # initialised on the CPU from a CPU generator (the same weights on any
    # device), then moved
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg["SEED"]))
    load_pretrained(cfg, model)
    freeze(cfg, model)
    model.to(device)

    optimizer, schedule = make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad],
                                         steps_per_epoch)
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
    # every rank starts from rank 0's state (the same seeded init and resume,
    # made certain)
    dist.broadcast_module(model)

    loss_cfg = cfg["LOSS"]
    debug = bool(cfg["DEBUG"]["DEBUG"])
    step_fn = make_train_step(state, loss_weights=m["LOSS_WEIGHTS"],
                              use_target_weight=loss_cfg["USE_TARGET_WEIGHT"],
                              use_ohkm=loss_cfg["USE_OHKM"], topk=loss_cfg["TOPK"],
                              remat=cfg["DEVICE"].get("REMAT", False), return_heatmaps=debug)
    generator = torch.Generator().manual_seed(cfg["SEED"] + 1)
    end_epoch = max_epochs if max_epochs is not None else cfg["TRAIN"]["END_EPOCH"]
    global_step = state.step
    print_freq = cfg["PRINT_FREQ"]

    for epoch in range(begin_epoch, end_epoch):
        loss_m, acc_m = AverageMeter(), AverageMeter()
        batch_t, data_t = AverageMeter(), AverageMeter()
        pending = []
        t0 = time.time()
        n_steps, epoch_iter = epoch_data(epoch)
        if max_steps_per_epoch:
            n_steps = max_steps_per_epoch if n_steps is None else min(n_steps,
                                                                      max_steps_per_epoch)
        epoch_iter = iter(epoch_iter)
        for i, raw in enumerate(epoch_iter):
            if n_steps is not None and i >= n_steps:
                break
            data_t.update(time.time() - t0)
            batch = to_device(raw)
            metrics = step_fn(batch, generator)
            if debug:
                heatmaps = metrics.pop("heatmaps_pred")
            pending.append(metrics)
            global_step += 1
            if i % print_freq == 0:
                for mt in pending:
                    _record(mt, loss_m, acc_m, epoch, i)
                pending.clear()
            batch_t.update(time.time() - t0)
            if on_step is not None:
                on_step(epoch, i, {**metrics, "data_time": data_t.val,
                                   "batch_time": batch_t.val})
            if i % print_freq == 0:
                logger.info("Epoch [%d][%d/%d] time %.3fs data %.3fs loss %.5f (%.5f) "
                            "acc %.3f (%.3f) lr %.2e", epoch, i, steps_per_epoch, batch_t.avg,
                            data_t.avg, loss_m.val, loss_m.avg, acc_m.val, acc_m.avg,
                            schedule(state.step))
                if debug and dist.is_main():
                    debug_dir = os.path.join(output_dir, "debug")
                    os.makedirs(debug_dir, exist_ok=True)
                    save_debug_images(cfg, batch, debug_meta(raw, m["IMAGE_SIZE"],
                                                             m["HEATMAP_SIZE"]),
                                      batch["target"], heatmaps,
                                      os.path.join(debug_dir, f"train_{epoch}_{i}"))
            t0 = time.time()
        if hasattr(epoch_iter, "close"):  # stop the prefetch threads left ahead of the loop
            epoch_iter.close()
        for mt in pending:  # metrics deferred past the last print
            _record(mt, loss_m, acc_m, epoch, i)
        pending.clear()

        perf = -1.0
        if val_dataset is not None and (epoch + 1) % validate_every == 0:
            name_value, perf = validate(cfg, val_dataset, model, output_dir, device=device)
            logger.info("=> epoch %d validation: %s", epoch,
                        ", ".join(f"{k} {v:.4f}" for k, v in name_value.items()))
        is_best = perf > best_perf
        best_perf = max(best_perf, perf)
        if dist.active() and not dist.same_on_every_rank(list(model.state_dict().values())):
            raise RuntimeError(f"the ranks' models differ after epoch {epoch}")
        if dist.is_main():
            save_checkpoint(output_dir, epoch, state, perf, is_best, model_name=m["NAME"],
                            train_global_steps=global_step)
        dist.barrier()
        logger.info("=> epoch %d done, loss %.5f, perf %.4f (best %.4f)", epoch, loss_m.avg,
                    perf, best_perf)

    if dist.is_main():
        save_final_state(output_dir, state)
    dist.barrier()
    return state
