"""A training cell: the recipe's step (``core/train.py::make_train_step``) on
``ops/preprocess.py::device_preprocess`` of raw host batches, as
``core/trainer.py::train_loop`` drives it with a ``batches`` callable (the
host-to-device copy included).

Set-up builds the model and its Adam state once, loads the seeded weights
and drives that same step through its first three steps on three different
batches: they warm every shape, and they are what the reference checks
(the losses, the first gradients as Adam holds them, the change after
three steps). The window then goes on stepping through the pool until its
end and closes when the last step has finished on the device; the rate is
over every valid person of every step in it. With ``--trace 1`` a traced
stretch of steps follows, spans around the copy, the preprocess, the step
and each encoder attention (forward and backward).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100 import check, flops, trace, traffic
from bench_h100.common import TRACE_SECONDS, free, now, peak_bytes, seeded_weights, sync
from bench_h100.reference.train import train_steps

#: steps an epoch, for the cosine schedule: the learning rate stays ``TRAIN.LR``
STEPS_PER_EPOCH = 10 ** 9
CHECKED_STEPS = 3


def run(job):
    from i2rnet_tpu_torch.core.train import SEED_RANGE, make_train_step
    from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
    from i2rnet_tpu_torch.core.trainer import raw_to_device
    from i2rnet_tpu_torch.models.encoder import SelfAttention
    from i2rnet_tpu_torch.models.interformer import build_model
    from i2rnet_tpu_torch.ops.preprocess import device_preprocess

    cfg, mix, cell, dev, seed = job["cfg"], job["mix"], job["cell"], job["device"], job["seed"]
    m, loss_cfg = cfg["MODEL"], cfg["LOSS"]
    batches = traffic.train_batches(mix, cfg, cfg["FLIP_PAIRS"], seed)
    valid = [int(r["person_valid"].sum()) for r in batches]
    model = build_model(cfg, device=dev)
    params, shapes, _ = seeded_weights(model, cfg, seed, dev, calibrated=False)
    opt, schedule = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    state = TrainState(model, opt, schedule)
    step = make_train_step(state, m["LOSS_WEIGHTS"], loss_cfg["USE_TARGET_WEIGHT"],
                           loss_cfg["USE_OHKM"], loss_cfg["TOPK"], cfg["DEVICE"]["REMAT"])
    prep = dict(image_size=tuple(m["IMAGE_SIZE"]), heatmap_size=tuple(m["HEATMAP_SIZE"]),
                sigma=m["SIGMA"])
    seeds = torch.Generator().manual_seed(seed)

    def one(raw):
        return step(device_preprocess(raw_to_device(raw, dev), **prep), seeds)

    named = dict(model.named_parameters())
    initial = {k: p.detach().clone() for k, p in named.items()}
    beta1 = opt.param_groups[0]["betas"][0]
    losses = []
    for t in range(CHECKED_STEPS):
        losses.append(float(one(batches[t])["loss"]))
        if t == 0:
            grad = {k: opt.state[p]["exp_avg"].detach() / (1 - beta1)
                    for k, p in named.items() if p in opt.state}
    change = {k: p.detach() - initial[k] for k, p in named.items()}
    sync(dev)
    setup_s = now() - job["t_start"]

    i, persons, steps = CHECKED_STEPS, 0, 0
    t0 = now()
    while now() - t0 < job["seconds"]:
        one(batches[i % len(batches)])
        persons += valid[i % len(batches)]
        i, steps = i + 1, steps + 1
    sync(dev)
    window_s = now() - t0
    per_image = [int(v) for r in batches for v in r["person_valid"].sum(1)]
    row = {n: flops.row_flops(cfg, shapes, n, backward=True) for n in set(per_image) if n}
    step_flops = {j: sum(row[int(n)] for n in r["person_valid"].sum(1) if n)
                  for j, r in enumerate(batches)}
    model_flops = sum(step_flops[(CHECKED_STEPS + s) % len(batches)] for s in range(steps))
    ctx = {"kind": "train", "window_s": window_s, "persons": persons, "flops": model_flops,
           "steps": steps}
    out = {"train_persons_s": persons / window_s, "setup_s": setup_s}

    if job["trace"]:
        attn = [mod for mod in model.modules() if isinstance(mod, SelfAttention)]
        hooks = trace.hook_module_spans(attn, "attention", backward=True)
        rows, traced_persons = [], 0
        try:
            with trace.traced() as tr:
                t1 = now()
                while now() - t1 < TRACE_SECONDS:
                    raw = batches[i % len(batches)]
                    with trace.span("copy"):
                        on_dev = raw_to_device(raw, dev)
                    with trace.span("preprocess"):
                        batch = device_preprocess(on_dev, **prep)
                    with trace.span("step"):
                        step(batch, seeds)
                    rows.append([int(v) for v in raw["person_valid"].sum(1)])
                    traced_persons += valid[i % len(batches)]
                    i += 1
        finally:
            for h in hooks:
                h.remove()
        red = trace.reduce(tr["events"], tr["window_s"])
        red["traced_persons"] = traced_persons
        red["attention_bound_s"] = flops.attention_bound(cfg, rows, 1, factor=3)
        ctx["trace"] = red
    memory = peak_bytes(dev)

    del state, opt, step, model, named
    free(dev)
    ref_seeds = torch.Generator().manual_seed(seed)
    step_seeds = [int(torch.randint(0, SEED_RANGE, (), generator=ref_seeds))
                  for _ in range(CHECKED_STEPS)]
    r_losses, r_grad, r_change = train_steps(params, cfg, batches[:CHECKED_STEPS], step_seeds, dev)
    numbers = check.train_numbers({"losses": losses, "grad": grad, "change": change},
                                  {"losses": r_losses, "grad": r_grad, "change": r_change})
    correct, compared = check.verdict(numbers, cell["limits"])
    return {"values": out, "ctx": ctx, "correct": correct, "attempted": steps + CHECKED_STEPS,
            "failed": 0, "memory": memory, "compared": compared,
            "printed": {"elements_left_out": numbers["left_out"], "losses": losses,
                        "reference_losses": r_losses, "valid_persons_per_image":
                        float(np.mean(per_image))}}
