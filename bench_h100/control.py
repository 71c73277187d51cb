"""The control of each cell's correctness check: the reference put in the
program's place and computed one precision below the configuration's.

The configurations compute in bfloat16, so the control rounds every operand
of every product (convolutions, linear layers, the attention's products)
to float8 e4m3 (``reference.nets.fp8``). A serving cell's control answers a
sample of the cell's requests (drawn as a run draws its sample, from the
pool) and is compared with the float32 reference as the served answers
are; a training cell's control takes the first three steps and is compared
as the program's steps are. The control has to come out not correct.

    python3 -m bench_h100.control --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers and whether each passed its
limit; it needs the card (the cell's own sizes).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from bench_h100 import check, traffic
from bench_h100.reference.nets import Net, exact_f32, fp8
from bench_h100.spec import Spec

REPO = Path(__file__).resolve().parent.parent


def serve_control(cfg, mix, cell, seed: int, device, model_shapes):
    from bench_h100.reference.nets import calibrate, seeded_params
    from bench_h100.reference.serve import answer

    params = seeded_params(model_shapes, seed, device)
    calibrate(params, cfg, seed, device)
    requests = traffic.serve_requests(mix, seed)
    rng = np.random.default_rng(seed + 7)
    pick = set(rng.choice(len(requests), size=cell["check_requests"], replace=False).tolist())
    pick.add(max(range(len(requests)), key=lambda i: (len(requests[i][1]), -i)))
    n_max = cell["buckets"][-1]
    ref, low = Net(params, cfg), Net(params, cfg, fp8)
    served, answers = [], []
    with torch.no_grad(), exact_f32():
        for i in sorted(pick):
            img = torch.as_tensor(requests[i][0], device=device)
            a = answer(ref, cfg, cfg["FLIP_PAIRS"], img, requests[i][1], n_max)
            b = answer(low, cfg, cfg["FLIP_PAIRS"], img, requests[i][1], n_max)
            answers.append(a)
            served.append(torch.cat([b["coords"], b["peak"][..., None]], -1).cpu().numpy())
    return check.serve_numbers(served, answers, cell["peak_margin"])


def train_control(cfg, mix, seed: int, device, model_shapes):
    from i2rnet_tpu_torch.core.train import SEED_RANGE

    from bench_h100.reference.nets import seeded_params
    from bench_h100.reference.train import train_steps

    params = seeded_params(model_shapes, seed, device)
    batches = traffic.train_batches(mix, cfg, cfg["FLIP_PAIRS"], seed)[:3]
    g = torch.Generator().manual_seed(seed)
    seeds = [int(torch.randint(0, SEED_RANGE, (), generator=g)) for _ in range(3)]
    ref = train_steps(params, cfg, batches, seeds, device)
    low = train_steps(params, cfg, batches, seeds, device, quant=fp8)
    keys = ("losses", "grad", "change")
    return check.train_numbers(dict(zip(keys, low)), dict(zip(keys, ref)))


def shapes_of(cfg):
    from i2rnet_tpu_torch.models.interformer import build_model

    model = build_model(cfg, device="meta")
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")]


def readings(spec, workload: str, seeds, device):
    """One dict a seed: the control's numbers and, against the cell's limits, ``correct``."""
    wl = spec.workload(workload)
    cfg, mix, cell = spec.config(wl["config"]), spec.traffic(wl["traffic"]), spec.cell(workload)
    shapes = shapes_of(cfg)
    out = []
    for seed in seeds:
        if mix["kind"] == "serve":
            numbers = serve_control(cfg, mix, cell, seed, device, shapes)
        else:
            numbers = train_control(cfg, mix, seed, device, shapes)
        correct, compared = check.verdict(numbers, cell["limits"])
        out.append({"workload": workload, "seed": seed, "correct": correct,
                    "numbers": numbers, "compared": compared})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_h100.control: needs a CUDA card", file=sys.stderr)
        return 2
    for row in readings(Spec(REPO), args.workload, args.seeds, "cuda:0"):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
