"""The training step.

Port of ``i2rnet_tpu/core/train.py`` (reference ``lib/core/function.py:
30-102``): forward in training mode, the masked heatmap loss, backward,
optimizer step, BatchNorm running statistics updated by the forward.
The model returns its heatmaps (``interformer_pureMulti``) or the
``{"single", "multi"}`` dict (``interformer``), whose ``single`` adds the
inter-supervision loss. Frozen parameters (``frozen_predicate``) are the
ones without ``requires_grad`` (``core/pretrained.py::freeze``), which the
trainer keeps out of the optimizer. ``DEVICE.REMAT`` (the JAX ``TPU.REMAT``)
recomputes activations in the backward instead of keeping them: ``dots``
and ``full`` here, around the forward and the loss (the JAX
``jax.checkpoint`` of the step), ``layers`` inside the model; the values
are ``REMAT_VALUES``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from i2rnet_tpu_torch.core.loss import joints_mse_loss, joints_ohkm_mse_loss
from i2rnet_tpu_torch.core.train_state import TrainState
from i2rnet_tpu_torch.models import layers
from i2rnet_tpu_torch.models.layers import REMAT_VALUES, check_remat
from i2rnet_tpu_torch.ops.accuracy import pck_accuracy

__all__ = ["REMAT_VALUES", "compute_losses", "make_train_step"]

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
                    use_ohkm: bool = False, topk: int = 8, remat="none",
                    return_heatmaps: bool = False):
    """``train_step(batch, generator) -> metrics``: one optimizer step on
    ``state`` in place.

    ``batch`` is ``device_preprocess``'s output (images, pos_masks, target,
    target_weight, person_valid). The step's dropout seed is drawn from
    ``generator`` (a ``torch.Generator`` the caller owns). The learning rate
    is ``state.schedule(state.step)``. Metrics (``loss``, ``acc``,
    ``loss_multi``, and ``loss_single`` where the model supervises it) stay
    device tensors, so no step waits on the host; PCK accuracy is on ``multi``.
    ``return_heatmaps`` adds the predicted ``multi`` heatmaps as
    ``heatmaps_pred`` (the ``DEBUG.DEBUG`` dumps).

    ``remat`` is ``DEVICE.REMAT``, checked here before any step runs:
    ``dots`` and ``full`` run the forward and the loss as one region that
    the backward recomputes (``models/layers.py::remat``), ``dots`` keeping
    the outputs of its unbatched matrix products; the other values leave the
    step as it is (``layers`` acts inside the model). The loss, gradients and
    statistics are those of the step without it.
    """
    check_remat(remat)
    policy = layers.save_products_policy if remat == "dots" else None

    def forward_loss(batch, seed):
        out = state.model(batch["images"], batch["pos_masks"], batch["person_valid"],
                          train=True, dropout_seed=seed)
        outputs = out if isinstance(out, dict) else {"single": None, "multi": out}
        loss, parts = compute_losses(outputs, batch, loss_weights, use_target_weight, use_ohkm,
                                     topk)
        return loss, parts, outputs["multi"]

    def train_step(batch, generator: torch.Generator):
        seed = int(torch.randint(0, SEED_RANGE, (), generator=generator))
        state.set_lr()
        if remat in ("dots", "full"):
            loss, parts, multi = layers.remat(state.model, forward_loss, batch, seed, policy=policy)
        else:
            loss, parts, multi = forward_loss(batch, seed)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        multi = multi.detach()
        with torch.no_grad():
            acc, _, _ = pck_accuracy(multi, batch["target"], batch["person_valid"])
        metrics = {"loss": loss.detach(), "acc": acc, **{k: v.detach() for k, v in parts.items()}}
        if return_heatmaps:
            metrics["heatmaps_pred"] = multi
        return metrics

    return train_step
