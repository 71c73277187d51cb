#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``i2rnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with CUDA

Phases, one line each (any failure exits non-zero):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels of ``i2rnet_tpu_torch/csrc`` from this checkout;
3. Kernel A (masked MHSA) against its plain PyTorch version on the card,
   f32 (TF32 off) and bf16, ragged masks with a fully padded image;
4. Kernel B (encoder FFN tail) likewise;
5. the W48-pure-en6 model at full width (seeded random weights, BatchNorm
   statistics calibrated so activations stay O(1)), one f32 forward at
   B=8, N=7 with the kernels on and off;
6. the serving path: requests served through ``serving.Predictor`` in bf16
   (batch 8, person buckets 2/4/7, 480x640 canvas, one image chunked), with
   Kernels A and B's launches counted from zero over that run;
7. timing, for information: eval-protocol persons/s (2 forwards + decode) at
   B=16, N=7, bf16, kernels on and off, and each kernel beside its plain
   version at the main-path shapes;
8. Kernel C (training MHSA with attention-weight dropout) forward and
   backward (dQ, dK, dV) against its plain version, f32 and bf16, at
   (B, S, C, H) = (8, 1344, 96, 1) and a small multi-head ragged shape, rate
   0.1 in bits and in seed mode (the plain version draws the same Philox
   bits), a fully padded image finite; the seed-mode keep fraction printed;
9. Kernel D (training FFN tail, both dropouts) forward and backward (dx and
   the eight parameter gradients) likewise at R=10752, C=96, F=192 and a
   ragged small shape;
10. the training path: W48-pure-en6 at full width, seeded as the JAX package
    initialises it, bf16, B=8 images x N=7 slots with ragged person counts,
    trained through ``core.trainer.train_loop`` on one repeated synthetic raw
    batch (numpy, ``data.synthetic``) for 8 steps with Kernels C and D: the
    losses finite and falling, each training kernel launched in this run
    (counts from zero), the checkpoint written and restored by AUTO_RESUME;
    then one f32 step at dropout 0 with the kernels on vs off (loss and every
    gradient within the stated bounds);
11. timing, for information: the train step (ms, persons/s) kernels on and
    off, a ``torch.profiler`` breakdown of the kernels-on step (device busy,
    idle share, launches, top kernels), and each training kernel beside its
    plain version at the main-path shapes, bf16, seed mode (a backward timed
    alone, on a graph recorded once), and the plain forwards again handed
    their bits.

Then a JSON line of the kernels, and last ``{"ok": true, "device": {...}}``.
TF32 is off throughout, so the float32 parts (crops, decode) stay float32.
Training writes its checkpoints under ``output/chip_smoke/`` of this checkout.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.train import compute_losses, make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import raw_to_device, train_loop
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.layers import MaskedBatchNorm
from i2rnet_tpu_torch.models.pure_multi import build_pure_multi, init_weights
from i2rnet_tpu_torch.ops.cuda import KERNELS, build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.dropout import threshold
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import _layer_norm, encoder_ffn_fused, encoder_ffn_torch
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import (encoder_ffn_train_fused,
                                                         encoder_ffn_train_torch, ffn_bits)
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused, masked_mhsa_torch
from i2rnet_tpu_torch.ops.cuda.mhsa_train import (attention_bits, masked_mhsa_train_fused,
                                                  masked_mhsa_train_torch)
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.serving import Predictor, make_eval_fn
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

SEED = 0
DEV = "cuda:0"
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # (atol, rtol)
HEAT_REL_BOUND = 1e-3
SOURCES = {
    "masked_mhsa": ("i2rnet_tpu_torch/csrc/mhsa.cu", "i2rnet_tpu/ops/pallas/mhsa.py:51"),
    "encoder_ffn": ("i2rnet_tpu_torch/csrc/encoder_ffn.cu",
                    "i2rnet_tpu/ops/pallas/encoder_ffn.py:103"),
    "mhsa_train_fwd": ("i2rnet_tpu_torch/csrc/mhsa_train.cu",
                       "i2rnet_tpu/ops/pallas/mhsa_train.py:182"),
    "mhsa_train_bwd": ("i2rnet_tpu_torch/csrc/mhsa_train.cu",
                       "i2rnet_tpu/ops/pallas/mhsa_train.py:207"),
    "encoder_ffn_train_fwd": ("i2rnet_tpu_torch/csrc/encoder_ffn_train.cu",
                              "i2rnet_tpu/ops/pallas/encoder_ffn_train.py:249"),
    "encoder_ffn_train_bwd": ("i2rnet_tpu_torch/csrc/encoder_ffn_train.cu",
                              "i2rnet_tpu/ops/pallas/encoder_ffn_train.py:280"),
}
EVAL_KERNELS = ("masked_mhsa", "encoder_ffn")
TRAIN_KERNELS = ("mhsa_train_fwd", "mhsa_train_bwd", "encoder_ffn_train_fwd",
                 "encoder_ffn_train_bwd")
OUT_DIR = Path(__file__).resolve().parent / "output" / "chip_smoke"
#: persons per image of the training batch: B=8 images x N=7 slots, ragged
TRAIN_COUNTS = [7, 5, 3, 1, 7, 2, 6, 4]
TRAIN_STEPS = 8
#: f32 training step, kernels on vs off: loss relative, and each gradient's
#: max |difference| over its max |value| (two f32 summation orders in the
#: encoder, amplified by the BatchNorms after it)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def flip_pairs(cfg):
    k = cfg["MODEL"]["NUM_JOINTS"]
    return [p for p in presets.COCO_FLIP_PAIRS if max(p) < k]


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def randn(*shape, g, dtype=torch.float32):
    return torch.randn(*shape, generator=g).to(DEV, dtype)


def compare(got, ref, dtype, what):
    """max |got - ref|; raises unless finite and within the stated tolerance."""
    atol, rtol = TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside atol={atol} "
                             f"rtol={rtol}, max |err| {err.max().item():.3g}")
    return err.max().item()


def ragged_mask(b, s, per_person, g):
    """[B, S] key-padding mask of images with 0..7 valid persons (image 0
    fully padded), or random padding with a fully padded row when S is not
    a whole number of persons."""
    if s % per_person == 0:
        n = s // per_person
        valid = torch.randint(1, n + 1, (b,), generator=g)
        valid[0] = 0
        mask = torch.arange(n).repeat_interleave(per_person)[None, :] >= valid[:, None]
    else:
        mask = torch.rand(b, s, generator=g) > 0.7
        mask[0] = True
    return mask.to(DEV)


def phase_mhsa(g):
    main_err = None
    for b, s, c, h in ((8, 1344, 96, 1), (2, 130, 24, 8)):
        mask = ragged_mask(b, s, 192, g)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (randn(b, s, c, g=g, dtype=dt) for _ in range(3))
            got = masked_mhsa_fused(q, k, v, h, mask)
            torch.cuda.synchronize()
            err = compare(got, masked_mhsa_torch(q, k, v, h, mask), dt,
                          f"masked_mhsa {(b, s, c, h)} {dt}")
            if (b, s, dt) == (8, 1344, torch.bfloat16):
                main_err = err
            log(f"  masked_mhsa B={b} S={s} C={c} H={h} {str(dt)[6:]}: max|err| {err:.3g} "
                f"(atol/rtol {TOL[dt][0]:g}/{TOL[dt][1]:g}), finite")
    return main_err


def ffn_params(c, f, g):
    return [1 + 0.2 * randn(c, g=g), 0.1 * randn(c, g=g),
            randn(f, c, g=g) / math.sqrt(c), 0.1 * randn(f, g=g),
            randn(c, f, g=g) / math.sqrt(f), 0.1 * randn(c, g=g),
            1 + 0.2 * randn(c, g=g), 0.1 * randn(c, g=g)]


def phase_ffn(g):
    main_err = None
    for rows, c, f in ((8 * 1344, 96, 192), (1003, 16, 32)):
        p = ffn_params(c, f, g)
        for dt in (torch.float32, torch.bfloat16):
            x = (2 * randn(rows, c, g=g) + 0.5).to(dt)
            got = encoder_ffn_fused(x, *p)
            torch.cuda.synchronize()
            err = compare(got, encoder_ffn_torch(x, *p), dt, f"encoder_ffn {(rows, c, f)} {dt}")
            if (rows, dt) == (8 * 1344, torch.bfloat16):
                main_err = err
            log(f"  encoder_ffn rows={rows} C={c} F={f} {str(dt)[6:]}: max|err| {err:.3g} "
                f"(atol/rtol {TOL[dt][0]:g}/{TOL[dt][1]:g}), finite")
    return main_err


#: kernel vs plain in training, as a share of the reference's largest
#: magnitude plus a relative part: (scaled atol, rtol). f32: two summation
#: orders; bf16: the plain version rounds its products' outputs (dP, the
#: gradients of its f32 casts) where the kernels keep f32, as the JAX kernels do.
TRAIN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}
RATE = 0.1


def compare_scaled(got, ref, dtype, what):
    """max |got - ref| / max |ref|; raises unless finite and within TRAIN_TOL."""
    atol, rtol = TRAIN_TOL[dtype]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    ref = ref.float()
    scale = ref.abs().max().clamp_min(1e-30)
    err = (got.float() - ref).abs()
    bad = err > atol * scale + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside {atol:g}*max|ref| + "
                             f"{rtol:g}*|ref|, max |err|/max|ref| {(err.max() / scale).item():.3g}")
    return err.max().item(), (err.max() / scale).item()


def fwd_bwd(fn, inputs, cot):
    """fn(*inputs) and the gradients of <fn(*inputs), cot> w.r.t. inputs."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, cot)
    return out.detach(), grads


def phase_mhsa_train(g):
    """Kernel C forward and backward vs plain: bits and seed modes, f32 and bf16."""
    errs = {}
    for b, s, c, h in ((8, 1344, 96, 1), (2, 130, 24, 8)):
        mask = ragged_mask(b, s, 192, g)
        bits = torch.randint(0, 2 ** 32, (b * h, s, s), generator=g, dtype=torch.int64).to(DEV)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, cot = (randn(b, s, c, g=g, dtype=dt) for _ in range(4))
            for mode in ("bits", "seed"):
                kw = ({"dropout_bits": bits} if mode == "bits"
                      else {"dropout_seed": 1234, "dropout_offset": 7})

                def run(fn):
                    return fwd_bwd(lambda q_, k_, v_: fn(q_, k_, v_, h, mask, RATE, **kw),
                                   (q, k, v), cot)

                got, gk = run(masked_mhsa_train_fused)
                torch.cuda.synchronize()
                ref, gr = run(masked_mhsa_train_torch)
                what = f"mhsa_train {(b, s, c, h)} {str(dt)[6:]} {mode}"
                e_f, r_f = compare_scaled(got, ref, dt, what + " out")
                e_b = [compare_scaled(x, y, dt, f"{what} d{n}") for n, x, y in zip("qkv", gk, gr)]
                if not torch.isfinite(got[0]).all():
                    raise AssertionError(f"{what}: the fully padded image is not finite")
                if (b, s, dt) == (8, 1344, torch.bfloat16) and mode == "seed":
                    errs = {"fwd": e_f, "bwd": max(e for e, _ in e_b)}
                log(f"  {what}: out max|err| {e_f:.3g} ({r_f:.2g} of max), dq/dk/dv "
                    + " ".join(f"{e:.3g} ({r:.2g})" for e, r in e_b))
    bits = attention_bits(1234, 7, 8, 1344, DEV)
    keep = (bits >= threshold(RATE)).float().mean().item()
    log(f"  seed-mode keep fraction over {bits.numel()} draws: {keep:.5f} (1 - rate = {1 - RATE})")
    if abs(keep - (1 - RATE)) > 1e-3:
        raise AssertionError(f"keep fraction {keep} strays from {1 - RATE}")
    return errs


def away_from_kink(x, p, g, eps=1e-4):
    """``x`` with each row redrawn until no linear1 pre-activation lies within
    ``eps`` of the ReLU kink, where two summation orders may take two branches
    (one flipped gate moves a whole row of dx)."""
    for _ in range(50):
        n = _layer_norm(x, p[0], p[1], 1e-5).to(x.dtype).float()
        h = n @ p[2].to(x.dtype).float().t() + p[3]
        near = (h.abs() < eps).any(-1)
        if not near.any():
            return x
        x = torch.where(near[:, None], (2 * randn(*x.shape, g=g) + 0.5).to(x.dtype), x)
    raise AssertionError("could not draw rows away from the ReLU kink")


def phase_ffn_train(g):
    """Kernel D forward and backward (dx + 8 parameter grads) vs plain."""
    errs = {}
    for rows, c, f in ((8 * 1344, 96, 192), (1003, 16, 32)):
        p = ffn_params(c, f, g)
        bits = (torch.randint(0, 2 ** 32, (rows, f), generator=g, dtype=torch.int64).to(DEV),
                torch.randint(0, 2 ** 32, (rows, c), generator=g, dtype=torch.int64).to(DEV))
        for dt in (torch.float32, torch.bfloat16):
            x = away_from_kink((2 * randn(rows, c, g=g) + 0.5).to(dt), p, g)
            cot = randn(rows, c, g=g, dtype=dt)
            for mode in ("bits", "seed"):
                kw = ({"dropout_bits": bits} if mode == "bits"
                      else {"dropout_seed": 99, "dropout_offset": 2})

                def run(fn):
                    return fwd_bwd(lambda *a: fn(*a, dropout_rate=RATE, **kw), (x, *p), cot)

                got, gk = run(encoder_ffn_train_fused)
                torch.cuda.synchronize()
                ref, gr = run(encoder_ffn_train_torch)
                what = f"encoder_ffn_train rows={rows} C={c} F={f} {str(dt)[6:]} {mode}"
                e_f, r_f = compare_scaled(got, ref, dt, what + " out")
                names = ("x", "ln1_w", "ln1_b", "w1", "b1", "w2", "b2", "ln2_w", "ln2_b")
                e_b = [compare_scaled(a, r, dt, f"{what} d{n}") for n, a, r in zip(names, gk, gr)]
                if rows == 8 * 1344 and dt == torch.bfloat16 and mode == "seed":
                    errs = {"fwd": e_f, "bwd": max(e for e, _ in e_b)}
                log(f"  {what}: out max|err| {e_f:.3g} ({r_f:.2g}), grads max of max|err|/max|ref| "
                    f"{max(r for _, r in e_b):.2g}")
    return errs


def person_inputs(cfg, b, n, counts, g):
    """Normalised crops, box position masks and validity for a [B, N] batch."""
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    images = randn(b, n, h, w, 3, g=g)
    pos = torch.zeros(b, n, h, w, 1)
    corners = torch.randint(0, min(h, w) // 2, (b, n, 2), generator=g).tolist()
    for i in range(b):
        for j in range(n):
            y0, x0 = corners[i][j]
            pos[i, j, y0:y0 + h // 2, x0:x0 + w // 2] = 1.0
    valid = torch.arange(n)[None, :] < torch.as_tensor(counts)[:, None]
    return images, pos.to(DEV), valid.to(DEV)


def random_model(cfg, g):
    """The recipe's model at full width with seeded random weights; each
    BatchNorm's running statistics set from its input on a calibration batch,
    so every layer's output is O(1)."""
    model = build_pure_multi(cfg, use_kernels=False, device=DEV)
    model.compute_dtype = torch.float32
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.5 + torch.rand(p.shape, generator=g))

    def calibrate(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    try:
        with torch.no_grad():
            model(*person_inputs(cfg, 2, 3, [3, 3], g))
    finally:
        for hk in hooks:
            hk.remove()
    return model


def phase_model(model, cfg, g):
    images, pos, valid = person_inputs(cfg, 8, 7, [7, 5, 3, 1, 7, 2, 6, 0], g)
    reset_launches()
    with torch.no_grad():
        model.global_encoder.use_kernels = True
        heat_on = model(images, pos, valid)
        torch.cuda.synchronize()
        counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
        model.global_encoder.use_kernels = False
        heat_off = model(images, pos, valid)
    if not torch.isfinite(heat_on).all():
        raise AssertionError("model forward with kernels: non-finite heatmaps")
    if heat_on[~valid].abs().max() != 0:
        raise AssertionError("padded persons' heatmaps are not zero")
    scale = heat_off.abs().max().item()
    rel = (heat_on - heat_off).abs().max().item() / scale
    if rel > HEAT_REL_BOUND or scale < 1e-3 or min(counts.values()) < 1:
        raise AssertionError(f"model: rel {rel:.3g} (bound {HEAT_REL_BOUND}), max|heat| "
                             f"{scale:.3g}, launches {counts}")
    log(f"  heatmaps {tuple(heat_on.shape)}: max|heat| {scale:.4g}, max|dheat|/max|heat| "
        f"{rel:.3g} (bound {HEAT_REL_BOUND:g}); launches in the kernel forward {counts}")


def requests(rng, n_images=12):
    """Synthetic uint8 images up to 480x640 with 1-9 person boxes each (one
    image with 9, more than the largest bucket, so it is chunked)."""
    images, boxes = [], []
    for i in range(n_images):
        h, w = int(rng.randint(240, 481)), int(rng.randint(320, 641))
        images.append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        n = 9 if i == 0 else int(rng.randint(1, 10))
        bw, bh = rng.uniform(40, w / 2, n), rng.uniform(80, h / 1.5, n)
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes.append(np.stack([x0, y0, bw, bh], 1).tolist())
    return images, boxes


def phase_serve(model, cfg):
    rng = np.random.RandomState(SEED)
    images, boxes = requests(rng)
    model.compute_dtype = torch.bfloat16
    model.global_encoder.use_kernels = True
    pred = Predictor(model, cfg, flip_pairs(cfg), batch_images=8, n_buckets=(2, 4, 7),
                     raw_hw=(480, 640))
    pred.predict(images[:2], boxes[:2])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = pred.predict(images, boxes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: launch_counts()[k] for k in EVAL_KERNELS}
    for i, (kp, bxs) in enumerate(zip(out, boxes)):
        if kp.shape != (len(bxs), cfg["MODEL"]["NUM_JOINTS"], 3) or not np.isfinite(kp).all():
            raise AssertionError(f"image {i}: result {kp.shape}, finite {np.isfinite(kp).all()}")
    if min(counts.values()) < 1:
        raise AssertionError(f"the served path launched no kernel: {counts}")
    model.global_encoder.use_kernels = False
    plain = pred.predict(images, boxes)
    conf = np.concatenate([k[..., 2] for k in out])
    conf_plain = np.concatenate([k[..., 2] for k in plain])
    xy_err = np.concatenate([np.abs(a[..., :2] - b[..., :2]).max(-1) for a, b in zip(out, plain)])
    conf_err = np.abs(conf - conf_plain).max() / np.abs(conf_plain).max()
    log(f"  {len(images)} images, {sum(map(len, boxes))} persons -> results "
        f"[n_i, {cfg['MODEL']['NUM_JOINTS']}, 3], "
        f"finite; host clock {dt * 1e3:.1f} ms (with host packing and copies); "
        f"launches {counts}")
    log(f"  bf16 kernels vs bf16 plain on the same requests: max|dconf|/max|conf| "
        f"{conf_err:.3g}, |dxy| median {np.median(xy_err):.3g} px, "
        f"share within 1 px {np.mean(xy_err <= 1.0):.3f}")
    if conf_err > 0.05 or np.median(xy_err) > 1.0:
        raise AssertionError("bf16 serving with kernels strays from the plain path")
    return counts


def time_cuda(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(a, b, iters):
    """ms of ``a`` and ``b`` timed in the order a, b, b, a; the mean of each pair."""
    ta1, tb1, tb2, ta2 = (time_cuda(f, iters) for f in (a, b, b, a))
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def train_cfg(dtype: str, use_kernels: bool):
    cfg = presets.w48_pure_en6()
    cfg["DEVICE"].update(COMPUTE_DTYPE=dtype, USE_KERNELS=use_kernels)
    cfg["PRINT_FREQ"] = 1
    return cfg


def seeded_model(cfg):
    """The model of ``cfg`` initialised as the JAX package does, on the card."""
    model = build_pure_multi(cfg)
    init_weights(model, gen(SEED))
    return model.to(DEV)


def phase_train(card):
    """The main path: ``train_loop`` at full width (bf16, kernels on, dropout
    0.1) on one repeated synthetic batch; launches counted from zero over it;
    then AUTO_RESUME from its checkpoint."""
    cfg = train_cfg("bfloat16", True)
    raw = synthetic_raw_batch(cfg, TRAIN_COUNTS, np.random.RandomState(SEED))
    out = OUT_DIR / "train"
    shutil.rmtree(out, ignore_errors=True)
    losses = []
    reset_launches()
    t0 = time.perf_counter()
    state = train_loop(cfg, str(out), lambda epoch: [raw] * TRAIN_STEPS, max_epochs=1,
                       device=DEV, on_step=lambda e, i, m: losses.append(float(m["loss"])))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: launch_counts()[k] for k in TRAIN_KERNELS}
    log(f"  {TRAIN_STEPS} steps, B=8 images x N=7 (persons {TRAIN_COUNTS}), bf16: losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + f"; host clock {dt:.2f} s with build and init; launches {counts}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"the loss does not fall on a repeated batch: {losses}")
    if min(counts.values()) < 1:
        raise AssertionError(f"the training path launched a kernel no time: {counts}")
    ckpt = latest_checkpoint(str(out))
    payload = load_checkpoint(ckpt)
    resumed = train_loop(cfg, str(out), lambda epoch: [raw] * TRAIN_STEPS, max_epochs=1,
                         device=DEV)
    same = all(torch.equal(v.cpu(), payload["state_dict"][k])
               for k, v in resumed.model.state_dict().items())
    same &= all(torch.equal(a.cpu(), b.cpu()) for k in state.optimizer.state_dict()["state"]
                for a, b in zip(state.optimizer.state_dict()["state"][k].values(),
                                resumed.optimizer.state_dict()["state"][k].values()))
    if not same or resumed.step != state.step or payload["epoch"] != 0:
        raise AssertionError(f"AUTO_RESUME from {ckpt} did not restore the trained state")
    log(f"  checkpoint {Path(ckpt).name} written; AUTO_RESUME restores its weights, optimizer "
        f"state and step {resumed.step}")
    return counts, raw


def phase_train_on_off(raw):
    """One f32 training step at dropout 0 (2 images, 12 persons) with the
    kernels on and off: the loss and every gradient."""
    cfg = train_cfg("float32", True)
    model = seeded_model(cfg)
    model.global_encoder.dropout_rate = 0.0
    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device({k: v[:2] for k, v in raw.items()}, DEV),
                              tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    res = {}
    for on in (True, False):
        model.global_encoder.use_kernels = on
        model.zero_grad(set_to_none=True)
        heat = model(batch["images"], batch["pos_masks"], batch["person_valid"], train=True)
        loss, _ = compute_losses({"multi": heat}, batch, m["LOSS_WEIGHTS"], True)
        loss.backward()
        res[on] = loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                if p.grad is not None}  # the unused branches have none
    (l_on, g_on), (l_off, g_off) = res[True], res[False]
    loss_rel = abs(l_on - l_off) / abs(l_off)
    grad_rel = {n: ((g_on[n] - g_off[n]).abs().max() / g_off[n].abs().max().clamp_min(1e-30)).item()
                for n in g_off}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"  loss {l_on:.8f} vs {l_off:.8f} (rel {loss_rel:.3g}, bound {TRAIN_LOSS_REL:g}); "
        f"{len(grad_rel)} gradients, worst max|dg|/max|g| {grad_rel[worst]:.3g} at {worst} "
        f"(bound {TRAIN_GRAD_REL:g})")
    if loss_rel > TRAIN_LOSS_REL or grad_rel[worst] > TRAIN_GRAD_REL:
        raise AssertionError("f32 training step with kernels strays from the plain path")


def profile_steps(fn, steps):
    """Device busy time, idle share, launches and the top kernels over
    ``steps`` calls of ``fn``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and "#" not in e.name]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy = (busy + cur_e - cur_s) / 1e3
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return wall / steps, busy / steps, len(kernels) / steps, [(n, t / steps, c / steps)
                                                               for n, (t, c) in top]


def phase_train_timing(raw, g, card):
    """Train step ms and persons/s at full width, bf16, dropout on, kernels on
    and off; a profile of the kernels-on step; each training kernel beside its
    plain version."""
    cfg = train_cfg("bfloat16", True)
    model = seeded_model(cfg)
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 1000))
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"])
    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device(raw, DEV), tuple(m["IMAGE_SIZE"]),
                              tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    dropout_gen = gen(SEED + 1)

    def run(on):
        def go():
            model.global_encoder.use_kernels = on
            step(batch, dropout_gen)
        return go

    persons = sum(TRAIN_COUNTS)
    t_off, t_on = alternate(run(False), run(True), 3)
    log(f"  train step B=8 N=7 ({persons} persons) bf16 dropout 0.1: kernels on {t_on:.2f} ms = "
        f"{persons / t_on * 1e3:.1f} persons/s; kernels off {t_off:.2f} ms = "
        f"{persons / t_off * 1e3:.1f} persons/s [{card}]")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall, busy, launches, top = profile_steps(run(True), 2)
    log(f"  profile, kernels on: wall {wall:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms/step, idle share {1 - busy / wall:.3f}, {launches:.0f} device "
        f"launches/step, peak memory {peak:.1f} GiB; top kernels (ms/step, launches/step):")
    for name, t, c in top:
        log(f"    {t:8.3f} {c:6.0f}  {name[:110]}")
    return phase_train_kernel_timing(g, card)


def backward_only(fn, inputs, cot):
    """A call that takes the gradient of one graph of ``fn``, recorded here
    once: timing it times the backward alone."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    return lambda: torch.autograd.grad(out, xs, cot, retain_graph=True)


def phase_train_kernel_timing(g, card):
    """Kernels C and D forward and backward beside their plain versions at the
    main-path shapes, bf16, seed mode; ms as (plain, kernel) pairs."""
    b, s, c, f = 8, 1344, 96, 192
    q, k, v, cot = (randn(b, s, c, g=g, dtype=torch.bfloat16) for _ in range(4))
    mask = ragged_mask(b, s, 192, g)
    kw = {"dropout_seed": 5, "dropout_offset": 0}

    def attn(fn):
        return lambda q_, k_, v_: fn(q_, k_, v_, 1, mask, RATE, **kw)

    times = {}
    with torch.no_grad():
        times["mhsa_train_fwd"] = alternate(lambda: attn(masked_mhsa_train_torch)(q, k, v),
                                            lambda: attn(masked_mhsa_train_fused)(q, k, v), 10)
    times["mhsa_train_bwd"] = alternate(
        backward_only(attn(masked_mhsa_train_torch), (q, k, v), cot),
        backward_only(attn(masked_mhsa_train_fused), (q, k, v), cot), 10)
    p = ffn_params(c, f, g)
    x = away_from_kink(randn(b * s, c, g=g, dtype=torch.bfloat16), p, g)
    cot2 = randn(b * s, c, g=g, dtype=torch.bfloat16)

    def tail(fn):
        return lambda *a: fn(*a, dropout_rate=RATE, **kw)

    with torch.no_grad():
        times["encoder_ffn_train_fwd"] = alternate(lambda: tail(encoder_ffn_train_torch)(x, *p),
                                                   lambda: tail(encoder_ffn_train_fused)(x, *p), 20)
    times["encoder_ffn_train_bwd"] = alternate(
        backward_only(tail(encoder_ffn_train_torch), (x, *p), cot2),
        backward_only(tail(encoder_ffn_train_fused), (x, *p), cot2), 20)
    for name, (plain_ms, ms) in times.items():
        log(f"  {name} B={b} S={s} C={c} bf16 seed mode: kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us [{card}]")
    # the plain forwards again with their bits drawn beforehand: their own
    # arithmetic, without the Philox rounds in int64 tensor ops
    bits_a = attention_bits(5, 0, b, s, DEV)
    bits_f = (ffn_bits(5, 0, b * s, f, DEV), ffn_bits(5, 1, b * s, c, DEV))
    with torch.no_grad():
        t_a = time_cuda(lambda: masked_mhsa_train_torch(q, k, v, 1, mask, RATE,
                                                        dropout_bits=bits_a), 10)
        t_f = time_cuda(lambda: encoder_ffn_train_torch(x, *p, dropout_rate=RATE,
                                                        dropout_bits=bits_f), 20)
    log(f"  plain forwards given their bits: mhsa_train {t_a * 1e3:.1f} us, encoder_ffn_train "
        f"{t_f * 1e3:.1f} us [{card}]")
    return times


def phase_timing(model, cfg, g, card):
    model.compute_dtype = torch.bfloat16
    b, n = 16, 7
    images, pos, valid = person_inputs(cfg, b, n, [n] * b, g)
    centers = torch.tensor([[128.0, 96.0]], device=DEV).repeat(b * n, 1)
    scales = torch.tensor([[1.2, 1.6]], device=DEV).repeat(b * n, 1)
    evaluate = make_eval_fn(cfg, model, flip_pairs(cfg))

    def step(on):
        def run():
            model.global_encoder.use_kernels = on
            evaluate(images, pos, valid, centers, scales)
        return run

    t_off, t_on = alternate(step(False), step(True), 5)
    log(f"  eval protocol B={b} N={n} bf16 (2 forwards + DARK decode): kernels on "
        f"{t_on:.2f} ms = {b * n / t_on * 1e3:.1f} persons/s; kernels off {t_off:.2f} ms = "
        f"{b * n / t_off * 1e3:.1f} persons/s [{card}]")

    times = {}
    s, c = n * 192, 96
    q, k, v = (randn(b, s, c, g=g, dtype=torch.bfloat16) for _ in range(3))
    mask = ragged_mask(b, s, 192, g)
    times["masked_mhsa"] = alternate(lambda: masked_mhsa_torch(q, k, v, 1, mask),
                                     lambda: masked_mhsa_fused(q, k, v, 1, mask), 20)
    x = randn(b * s, c, g=g, dtype=torch.bfloat16)
    p = ffn_params(c, 192, g)
    times["encoder_ffn"] = alternate(lambda: encoder_ffn_torch(x, *p),
                                     lambda: encoder_ffn_fused(x, *p), 20)
    for name, (plain_ms, ms) in times.items():
        log(f"  {name} B={b} S={s} C={c} bf16: kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us [{card}]")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 1 device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(card)

    t0 = time.perf_counter()
    so = build.build()
    build.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {so.name}")

    g = gen(SEED)
    log("phase 3 masked_mhsa kernel vs plain:")
    mhsa_err = phase_mhsa(g)
    log("phase 4 encoder_ffn kernel vs plain:")
    ffn_err = phase_ffn(g)

    cfg = presets.w48_pure_en6()
    model = random_model(cfg, g)
    log("phase 5 W48-pure-en6 full width, f32, B=8 N=7, kernels on vs off:")
    phase_model(model, cfg, g)
    log("phase 6 serving through Predictor (bf16, batch 8, buckets 2/4/7):")
    counts = phase_serve(model, cfg)
    log(f"phase 7 timing [{card}]:")
    times = phase_timing(model, cfg, g, card)
    del model
    torch.cuda.empty_cache()

    log("phase 8 mhsa_train (Kernel C) forward and backward vs plain:")
    c_err = phase_mhsa_train(g)
    log("phase 9 encoder_ffn_train (Kernel D) forward and backward vs plain:")
    d_err = phase_ffn_train(g)
    log("phase 10 training W48-pure-en6 through train_loop (bf16, B=8 N=7, kernels on):")
    train_counts, raw = phase_train(card)
    log("  one f32 step at dropout 0, kernels on vs off (2 images, 12 persons):")
    phase_train_on_off(raw)
    log(f"phase 11 training timing [{card}]:")
    times.update(phase_train_timing(raw, g, card))

    counts.update(train_counts)
    errs = {"masked_mhsa": mhsa_err, "encoder_ffn": ffn_err,
            "mhsa_train_fwd": c_err["fwd"], "mhsa_train_bwd": c_err["bwd"],
            "encoder_ffn_train_fwd": d_err["fwd"], "encoder_ffn_train_bwd": d_err["bwd"]}
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": counts[name],
                "max_abs_err": errs[name], "ms": times[name][1], "plain_ms": times[name][0]}
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
