"""FLOPs and forward time of a model: ``python3 -m i2rnet_tpu_torch.tools.compute_flops``.

Port of ``tools/compute_flops.py`` of the JAX package (reference
``tools/compute_flops.py``; the paper's GFLOPs column), with its flags and
its JSON keys:

    python3 -m i2rnet_tpu_torch.tools.compute_flops --preset coco_w48 --batch 8 --persons 7
    python3 -m i2rnet_tpu_torch.tools.compute_flops --cfg <yaml> [opts ...]
    python3 -m i2rnet_tpu_torch.tools.compute_flops --cfg <yaml> --dataset  # the paper's
        protocol: the first --num-samples val images, GFLOPs per image and per person

The FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of one
eval forward (no flip test, no decode, as the JAX tool's), the model routed
through the registered ``i2r::`` ops (``ops/cuda/library.py::through_ops``)
so that each hand kernel is counted by its formula: two FLOPs per
multiply-add of its plain version. ``FlopCounterMode`` counts products and
convolutions only; the JAX tool reads XLA's ``cost_analysis()``, which counts
elementwise work too, so the JAX figure is the larger. ``hbm_gb_per_batch``
is the bytes the eager forward's ops read and write (each op's tensor inputs
and outputs, views left out), the counterpart of XLA's "bytes accessed" for
a program that fuses nothing. The time is the forward's: ``--iters`` warm-up
calls, then ``--iters`` calls between CUDA events (the host clock on
``--device cpu``). Weights are seeded (``init_weights``, ``SEED``) unless
``TEST.MODEL_FILE`` names a file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.pretrained import load_model_file
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.cuda.library import through_ops
from i2rnet_tpu_torch.registry import get_dataset_class
from i2rnet_tpu_torch.config.config import load_config, to_port

PRESETS = ("coco_w48", "coco_tph", "tph_single")


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="FLOPs and forward time of I2R-Net (PyTorch/CUDA)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--preset", default="coco_w48", choices=PRESETS)
    p.add_argument("--batch", type=int, default=8, help="images per batch")
    p.add_argument("--persons", type=int, default=7, help="persons per image")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dataset", action="store_true",
                   help="average over the first N val images (paper protocol)")
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def preset_cfg(name: str) -> Dict:
    """The config of a ``--preset``: the COCO W48 or TPH recipe, or TPH's
    first stage alone (``transpose_h``, reference
    ``tools/compute_flops_transpose.py``)."""
    if name == "coco_w48":
        return presets.w48_pure_en6("coco")
    cfg = presets.tph_interformer()
    if name == "tph_single":
        cfg["MODEL"]["NAME"] = "transpose_h"
    return cfg


class BytesMode(TorchDispatchMode):
    """The bytes each op reads and writes: its tensor inputs and outputs,
    each counted once a call; view ops move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            tensors = [t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out


def forward_fn(cfg: Dict, model):
    """``forward(images, pos_masks, person_valid)`` -> the heatmaps the JAX
    tool takes: ``multi``, or the single-person model's heatmaps."""
    if cfg["MODEL"]["NAME"] in ("transpose_h", "transpose_h_old"):
        def single(images, pos_masks, person_valid):
            b, n, h, w, _ = images.shape
            return model(images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2))[1]
        return single

    def multi(images, pos_masks, person_valid):
        out = model(images, pos_masks, person_valid)
        return out["multi"] if isinstance(out, dict) else out

    return multi


def count(forward, *inputs):
    """(FLOPs, bytes) of one call of ``forward``, the kernels as their ops."""
    with torch.inference_mode(), through_ops(), BytesMode() as moved, \
            FlopCounterMode(display=False) as flops:
        forward(*inputs)
    return flops.get_total_flops(), moved.bytes


def seconds_per_call(forward, inputs, iters: int, device) -> float:
    """``iters`` warm-up calls, then the mean of ``iters`` timed ones."""
    with torch.inference_mode():
        for _ in range(iters):
            forward(*inputs)
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                forward(*inputs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            forward(*inputs)
        return (time.perf_counter() - t0) / iters


def build(cfg: Dict, device):
    """The model of ``cfg`` on ``device`` in eval mode, seeded or from
    ``TEST.MODEL_FILE``."""
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(cfg["SEED"]))
    if cfg["TEST"].get("MODEL_FILE"):
        load_model_file(cfg["TEST"]["MODEL_FILE"], model)
    return model.to(device).eval()


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def measure(cfg: Dict, batch: int, persons: int, iters: int, device="cuda") -> Dict:
    """The JAX tool's report for a ``batch`` x ``persons`` batch of seeded
    random crops (one person an image for the single-person model)."""
    device = torch.device(device)
    model = build(cfg, device)
    forward = forward_fn(cfg, model)
    if cfg["MODEL"]["NAME"] in ("transpose_h", "transpose_h_old"):
        persons = 1
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    rng = np.random.RandomState(0)
    dt = model_dtype(cfg)
    images = torch.from_numpy(rng.rand(batch, persons, h, w, 3).astype(np.float32))
    pos = torch.from_numpy((rng.rand(batch, persons, h, w, 1) > 0.5).astype(np.float32))
    inputs = (images.to(device, dt), pos.to(device, dt),
              torch.ones(batch, persons, dtype=torch.bool, device=device))
    flops, moved = count(forward, *inputs)
    sec = seconds_per_call(forward, inputs, iters, device)
    n = batch * persons
    return {"model": cfg["MODEL"]["NAME"], "input": f"{h}x{w}", "batch_images": batch,
            "persons_per_image": persons, "gflops_per_batch": round(flops / 1e9, 2),
            "gflops_per_person": round(flops / n / 1e9, 3),
            "hbm_gb_per_batch": round(moved / 1e9, 3), "latency_ms": round(sec * 1e3, 3),
            "persons_per_sec": round(n / sec, 1), "fps_images": round(batch / sec, 1),
            "tflops_per_sec": round(flops / sec / 1e12, 3), "device": device_name(device)}


def model_dtype(cfg: Dict):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg["DEVICE"]["COMPUTE_DTYPE"]]


def dataset_protocol(cfg: Dict, num_samples: int, iters: int, device="cuda") -> Dict:
    """The reference protocol (``compute_flops.py:109-167``): the first
    ``num_samples`` val images one at a time, each in its person bucket;
    FLOPs and time counted once a bucket. FLOPs include the padded persons
    (what the program spends); per person divides by the real persons."""
    device = torch.device(device)
    model = build(cfg, device)
    forward = forward_fn(cfg, model)
    d = cfg["DATASET"]
    ds = get_dataset_class(d["DATASET"])(cfg, d["ROOT"], d["TEST_SET"], is_train=False)
    by_bucket: Dict[int, tuple] = {}
    total_flops = total_persons = total_time = n_images = 0
    for items, nb in ds.eval_batches(1):
        if n_images >= num_samples:
            break
        raw, _ = ds.make_raw_batch(items, nb)
        batch = ds.device_batch(raw, device)
        inputs = (batch["images"].to(model_dtype(cfg)), batch["pos_masks"].to(model_dtype(cfg)),
                  batch["person_valid"])
        if nb not in by_bucket:
            by_bucket[nb] = (count(forward, *inputs)[0],
                             seconds_per_call(forward, inputs, iters, device))
        flops, sec = by_bucket[nb]
        total_flops += flops
        total_time += sec
        total_persons += int(np.asarray(raw["person_valid"]).sum())
        n_images += 1
    return {"protocol": f"first {n_images} val images (reference compute_flops.py:109-167)",
            "model": cfg["MODEL"]["NAME"], "dataset": d["DATASET"],
            "gflops_per_image_mean": round(total_flops / max(n_images, 1) / 1e9, 3),
            "gflops_per_person": round(total_flops / max(total_persons, 1) / 1e9, 3),
            "persons_total": int(total_persons),
            "fps_images": round(n_images / max(total_time, 1e-9), 2),
            "persons_per_sec": round(total_persons / max(total_time, 1e-9), 1),
            "device": device_name(device)}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.cfg:
        cfg = to_port(load_config(args.cfg, opts=args.opts or []))
    else:
        cfg = preset_cfg(args.preset)
    if args.dataset:
        report = dataset_protocol(cfg, args.num_samples, args.iters, args.device)
    else:
        report = measure(cfg, args.batch, args.persons, args.iters, args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
