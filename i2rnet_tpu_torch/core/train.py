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

Data parallelism (a process group of more than one rank,
``parallel/dist.py``): each rank runs its rows of the global batch. Its loss
divides its own sum by the global count of valid persons, so the global
loss is the sum of the ranks' losses, as the JAX loss over a sharded batch
(``i2rnet_tpu/core/loss.py:41-49,74-76``); the BatchNorms sum their
statistics over the ranks (``models/layers.py::MaskedBatchNorm``). After the
backward one flattened all-reduce sums the trainable parameters' gradients
(``dist.all_reduce_grads``; summed, not averaged, since each rank's loss is
already its share of the global one). It is not ``DistributedDataParallel``:
DDP raises on parameters a forward never reads (the HRFormer's carried
relative-position table) unless it searches the graph every step
(``find_unused_parameters``), and it averages; one all-reduce of the
optimizer's parameters leaves frozen ones out and keeps the step's order
of work the one-process step's. The logged loss and accuracy are the global
ones. Each rank folds its rank into the step's dropout seed
(:func:`rank_seed`; rank 0 keeps it), so no two ranks drop the same
elements of their rows. A world of one runs the step it ran without.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from i2rnet_tpu_torch.core.loss import joints_mse_loss, joints_ohkm_mse_loss
from i2rnet_tpu_torch.core.train_state import TrainState
from i2rnet_tpu_torch.models import layers
from i2rnet_tpu_torch.models.layers import REMAT_VALUES, check_remat
from i2rnet_tpu_torch.ops.accuracy import pck_accuracy, pck_counts, pck_from_counts
from i2rnet_tpu_torch.parallel import dist

__all__ = ["REMAT_VALUES", "compute_losses", "make_train_step"]

SEED_RANGE = 2 ** 31 - 1
#: the step seed of rank r is moved by r times this (modulo SEED_RANGE)
RANK_SEED_STRIDE = 1_000_003


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank`` for the step seed ``seed``: ``seed`` on
    rank 0, moved by ``rank * RANK_SEED_STRIDE`` elsewhere."""
    return (int(seed) + int(rank) * RANK_SEED_STRIDE) % SEED_RANGE


def compute_losses(outputs: Dict, batch, loss_weights: Sequence[float], use_target_weight: bool,
                   use_ohkm: bool = False, topk: int = 8):
    """``w0 * MSE(single) + w1 * MSE(multi)`` when both branches are
    supervised, else MSE(multi) (reference ``function.py:52-57``);
    ``LOSS.USE_OHKM`` takes the hard-keypoint-mining loss. Under data
    parallelism each rank's part, over the global count of valid persons."""
    tw = batch["target_weight"] if use_target_weight else None
    valid = batch["person_valid"]
    # the global batch's valid persons (this batch's in a world of one)
    count = dist.all_reduce_sum(valid.sum().float()) if dist.active() else None

    def crit(pred):
        if use_ohkm:
            return joints_ohkm_mse_loss(pred, batch["target"], tw, valid, topk=topk, count=count)
        return joints_mse_loss(pred, batch["target"], tw, valid, count=count)

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
        seed = rank_seed(int(torch.randint(0, SEED_RANGE, (), generator=generator)), dist.rank())
        state.set_lr()
        if remat in ("dots", "full"):
            loss, parts, multi = layers.remat(state.model, forward_loss, batch, seed, policy=policy)
        else:
            loss, parts, multi = forward_loss(batch, seed)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if dist.active():
            dist.all_reduce_grads([p for group in state.optimizer.param_groups
                                   for p in group["params"]])
        state.optimizer.step()
        state.step += 1
        multi = multi.detach()
        with torch.no_grad():
            if dist.active():
                metrics = global_metrics(loss, parts, multi, batch)
            else:
                acc, _, _ = pck_accuracy(multi, batch["target"], batch["person_valid"])
                metrics = {"loss": loss.detach(), "acc": acc,
                           **{k: v.detach() for k, v in parts.items()}}
        if return_heatmaps:
            metrics["heatmaps_pred"] = multi
        return metrics

    return train_step


def global_metrics(loss, parts, multi, batch):
    """The global batch's loss, its parts and PCK accuracy: the ranks' losses
    (each already over the global count) and accuracy counts summed in one
    all-reduce."""
    hit, cnt = pck_counts(multi, batch["target"], batch["person_valid"])
    names = list(parts)
    local = torch.cat([torch.stack([loss.detach().float()] + [parts[k].detach().float()
                                                              for k in names]),
                       hit.float(), cnt.float()])
    total = dist.all_reduce_sum(local)
    k = hit.numel()
    acc, _, _ = pck_from_counts(total[-2 * k:-k], total[-k:])
    return {"loss": total[0], "acc": acc, **{n: total[1 + i] for i, n in enumerate(names)}}
