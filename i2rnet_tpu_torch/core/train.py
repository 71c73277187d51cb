"""The training step.

Port of ``i2rnet_tpu/core/train.py`` (reference ``lib/core/function.py:
30-102``): forward in training mode, the masked heatmap loss, backward,
optimizer step, BatchNorm running statistics updated by the forward.
The model returns its heatmaps (``interformer_pureMulti``) or the
``{"single", "multi"}`` dict (``interformer``), whose ``single`` adds the
inter-supervision loss. ``TPU.REMAT`` and ``frozen_predicate`` are not ported
(no recipe of these slices uses them; ROADMAP).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from i2rnet_tpu_torch.core.loss import joints_mse_loss, joints_ohkm_mse_loss
from i2rnet_tpu_torch.core.train_state import TrainState
from i2rnet_tpu_torch.ops.accuracy import pck_accuracy

SEED_RANGE = 2 ** 31 - 1


def compute_losses(outputs: Dict, batch, loss_weights: Sequence[float], use_target_weight: bool,
                   use_ohkm: bool = False, topk: int = 8):
    """``w0 * MSE(single) + w1 * MSE(multi)`` when both branches are
    supervised, else MSE(multi) (reference ``function.py:52-57``);
    ``LOSS.USE_OHKM`` takes the hard-keypoint-mining loss."""
    tw = batch["target_weight"] if use_target_weight else None
    valid = batch["person_valid"]

    def crit(pred):
        if use_ohkm:
            return joints_ohkm_mse_loss(pred, batch["target"], tw, valid, topk=topk)
        return joints_mse_loss(pred, batch["target"], tw, valid)

    multi = crit(outputs["multi"])
    if outputs.get("single") is not None:
        single = crit(outputs["single"])
        return (loss_weights[0] * single + loss_weights[1] * multi,
                {"loss_single": single, "loss_multi": multi})
    return multi, {"loss_multi": multi}


def make_train_step(state: TrainState, loss_weights=(0.5, 0.5), use_target_weight: bool = True,
                    use_ohkm: bool = False, topk: int = 8):
    """``train_step(batch, generator) -> metrics``: one optimizer step on
    ``state`` in place.

    ``batch`` is ``device_preprocess``'s output (images, pos_masks, target,
    target_weight, person_valid). The step's dropout seed is drawn from
    ``generator`` (a ``torch.Generator`` the caller owns). The learning rate
    is ``state.schedule(state.step)``. Metrics (``loss``, ``acc``,
    ``loss_multi``, and ``loss_single`` where the model supervises it) stay
    device tensors, so no step waits on the host; PCK accuracy is on ``multi``.
    """

    def train_step(batch, generator: torch.Generator):
        seed = int(torch.randint(0, SEED_RANGE, (), generator=generator))
        state.set_lr()
        out = state.model(batch["images"], batch["pos_masks"], batch["person_valid"],
                          train=True, dropout_seed=seed)
        outputs = out if isinstance(out, dict) else {"single": None, "multi": out}
        loss, parts = compute_losses(outputs, batch, loss_weights, use_target_weight, use_ohkm,
                                     topk)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc, _, _ = pck_accuracy(outputs["multi"].detach(), batch["target"],
                                     batch["person_valid"])
        return {"loss": loss.detach(), "acc": acc, **{k: v.detach() for k, v in parts.items()}}

    return train_step
