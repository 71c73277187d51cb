"""Train state, optimizer and per-epoch cosine schedule.

Port of ``i2rnet_tpu/core/train_state.py``, with the reference's optimizer
semantics (``lib/utils/utils.py:85-101``): Adam with ``TRAIN.LR`` and no
weight decay, or SGD with momentum, weight decay and nesterov; the learning
rate follows a per-epoch CosineAnnealingLR from ``LR`` to ``LR_END`` over
``END_EPOCH`` epochs (``tools/ddp_train.py:217-218``), set before each
optimizer step from ``step // steps_per_epoch``. ``torch.optim`` does the
updates (the JAX package has no kernel in its optimizer); its Adam and SGD
are optax's ``adam`` and ``add_decayed_weights`` + ``sgd`` step for step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch


def cosine_epoch_schedule(lr: float, lr_end: float, end_epoch: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """``lr_end + (lr - lr_end) * (1 + cos(pi * epoch / T)) / 2`` with
    ``epoch = min(step // steps_per_epoch, T)``."""
    def schedule(step: int) -> float:
        epoch = min(int(step) // max(steps_per_epoch, 1), end_epoch)
        return lr_end + (lr - lr_end) * 0.5 * (1 + math.cos(math.pi * epoch / end_epoch))
    return schedule


def make_optimizer(cfg: Dict, params, steps_per_epoch: int):
    """(optimizer, schedule) from ``cfg["TRAIN"]``."""
    t = cfg["TRAIN"]
    sched = cosine_epoch_schedule(t["LR"], t["LR_END"], t["END_EPOCH"], steps_per_epoch)
    if t["OPTIMIZER"] == "adam":
        opt = torch.optim.Adam(params, lr=sched(0))  # WD unused, as the reference
    elif t["OPTIMIZER"] == "sgd":
        opt = torch.optim.SGD(params, lr=sched(0), momentum=t["MOMENTUM"],
                              weight_decay=t["WD"], nesterov=t["NESTEROV"])
    else:
        raise ValueError(f"unknown optimizer {t['OPTIMIZER']!r}")
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, and the count of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def set_lr(self) -> float:
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr
