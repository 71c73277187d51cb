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
6. the main path: requests served through ``serving.Predictor`` in bf16
   (batch 8, person buckets 2/4/7, 480x640 canvas, one image chunked), with
   the kernels' launches counted from zero over that run;
7. timing, for information: eval-protocol persons/s (2 forwards + decode) at
   B=16, N=7, bf16, kernels on and off, and each kernel beside its plain
   version at the main-path shapes.

Then a JSON line of the kernels, and last ``{"ok": true, "device": {...}}``.
TF32 is off throughout, so the float32 parts (crops, decode) stay float32.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.models.layers import MaskedBatchNorm
from i2rnet_tpu_torch.models.pure_multi import build_pure_multi
from i2rnet_tpu_torch.ops.cuda import KERNELS, build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused, encoder_ffn_torch
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused, masked_mhsa_torch
from i2rnet_tpu_torch.serving import Predictor, make_eval_fn

SEED = 0
DEV = "cuda:0"
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # (atol, rtol)
HEAT_REL_BOUND = 1e-3
SOURCES = {
    "masked_mhsa": ("i2rnet_tpu_torch/csrc/mhsa.cu", "i2rnet_tpu/ops/pallas/mhsa.py:51"),
    "encoder_ffn": ("i2rnet_tpu_torch/csrc/encoder_ffn.cu",
                    "i2rnet_tpu/ops/pallas/encoder_ffn.py:103"),
}


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
        counts = launch_counts()
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
    counts = launch_counts()
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

    errs = {"masked_mhsa": mhsa_err, "encoder_ffn": ffn_err}
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
