"""A device trace of the eval or train step: ``python3 -m i2rnet_tpu_torch.tools.profile``.

Port of ``tools/profile.py`` of the JAX package (its ``jax.profiler``
trace): ``torch.profiler`` over ``--iters`` calls of the forward (B=8 x N=7
random crops by default) or, with ``--train``, of the training step
(``core/train.py::make_train_step``, ``DEVICE.REMAT`` of the preset), after
one untraced call; the Chrome trace (``chrome://tracing`` or Perfetto) is
written to ``<out>/trace.json`` and the device time by kernel printed.
Weights are seeded.

    python3 -m i2rnet_tpu_torch.tools.profile [--train] [--preset w48|tph|hrt] \\
        [--out output/profile] [--iters 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.train import make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.tools.compute_flops import build, forward_fn, model_dtype

PRESETS = {"w48": presets.w48_pure_en6, "tph": presets.tph_interformer,
           "hrt": presets.hrt_interformer}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Trace the eval or train step of I2R-Net")
    p.add_argument("--out", default=os.path.join("output", "profile"))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--train", action="store_true", help="profile a train step")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--persons", type=int, default=7)
    p.add_argument("--preset", default="w48", choices=list(PRESETS),
                   help="model family (vanilla / TransPose-H / HRFormer-B)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def step_fn(cfg, model, b: int, n: int, train: bool, device):
    """One call of what is traced, on seeded random inputs."""
    rng = np.random.RandomState(0)
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    dt = model_dtype(cfg)
    batch = {"images": torch.from_numpy(rng.rand(b, n, h, w, 3).astype(np.float32)).to(device, dt),
             "pos_masks": torch.from_numpy((rng.rand(b, n, h, w, 1) > 0.5).astype(np.float32)
                                           ).to(device, dt),
             "person_valid": torch.ones(b, n, dtype=torch.bool, device=device)}
    if not train:
        forward = forward_fn(cfg, model)

        @torch.inference_mode()
        def evaluate():
            forward(batch["images"], batch["pos_masks"], batch["person_valid"])
        return evaluate
    k = cfg["MODEL"]["NUM_JOINTS"]
    hw, hh = cfg["MODEL"]["HEATMAP_SIZE"]
    batch["target"] = torch.from_numpy(rng.rand(b, n, k, hh, hw).astype(np.float32)).to(device)
    batch["target_weight"] = torch.ones(b, n, k, device=device)
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 100))
    train_step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"],
                                 remat=cfg["DEVICE"].get("REMAT", False))
    generator = torch.Generator().manual_seed(1)
    return lambda: train_step(batch, generator)


def trace(cfg, out: str, iters: int, train: bool, b: int, n: int, device="cuda"):
    """Write ``<out>/trace.json`` of ``iters`` calls; the profiler."""
    device = torch.device(device)
    model = build(cfg, device)
    fn = step_fn(cfg, model, b, n, train, device)
    fn()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    return prof


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    cfg = PRESETS[args.preset]()
    prof = trace(cfg, args.out, args.iters, args.train, args.batch, args.persons, args.device)
    sort = "self_cuda_time_total" if args.device != "cpu" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=15))
    print(f"trace written to {os.path.join(args.out, 'trace.json')} (open with Perfetto or "
          "chrome://tracing)")
    return prof


if __name__ == "__main__":
    main(sys.argv[1:])
