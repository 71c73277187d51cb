"""First card check of the FFN tail's bf16 tensor-core body (``csrc/ffn_tile.cuh``:
Kernel B, and Kernel D forward and backward): build, each kernel's registers
and spills from the compiler's report, the tensor-core instructions (``HMMA``)
in the SASS of the bf16 kernels, the plans at the main-path shapes; then
``chip_smoke.py``'s phases 4 and 9 (B and D against their plain versions at
every shape, f32 and bf16; two bf16 backward calls bit-equal); and last B and D
as device time per call beside their plain versions, at the W48 shapes (C = 96:
B at R = 21504, D at R = 10752) and the HRT shapes (C = 78: B at R = 6144, D at
R = 4608), D also with dropout off, with the kernels each call launches.

    python3 -m i2rnet_tpu_torch.probes.ffn_probe [--timing]   # repository root, on a card

``--timing`` skips the build report and the checks. Run from another checkout
(``PYTHONPATH=<tree> python3 <this file> --timing`` in that tree's root) it
times that tree's kernels with the same calls, so two versions compare in one
card call.
"""

from __future__ import annotations

import sys
import time

#: the bf16 body's kernels as their SASS names them, and the f32 template's
KERNEL_NAMES = ("fwd_kernel", "bwd_rows_kernel", "dw_kernel", "encoder_ffn_kernel",
                "ffn_train_bwd_rows_kernel")
#: (label, rows, C) of the timed shapes, F = 192
TIMED = (("W48 eval", 16 * 1344, 96), ("W48 train", 8 * 1344, 96),
         ("HRT eval", 8 * 768, 78), ("HRT train", 12 * 384, 78))


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda import encoder_ffn as ffn_b
    from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import (encoder_ffn_train_fused,
                                                             encoder_ffn_train_torch)
    from i2rnet_tpu_torch.probes.mhsa_probe import by_kernel, kernel_resources
    from i2rnet_tpu_torch.probes.mlp_probe import hmma_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.time()
    so = build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s ({build.CSRC.parent})", flush=True)
    timing_only = "--timing" in sys.argv
    if not timing_only:
        for src, name, regs, st, ld in kernel_resources(
                so.with_suffix(".log").read_text(), ("encoder_ffn.cu", "encoder_ffn_train.cu",
                                                   "encoder_ffn_train_wide.cu")):
            print(f"  {src:22s} {name:64s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
        for name, n in hmma_counts(so, KERNEL_NAMES).items():
            print(f"  SASS {name[:100]}: {n} HMMA", flush=True)
    plan = getattr(ffn_b, "ffn_plan", None)
    if plan is not None:
        from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import sm_count
        for label, rows, c in TIMED:
            print(f"  plan {label} rows={rows} C={c} F=192: {plan(rows, c, 192, sm_count(0), True)}",
                  flush=True)
    g = cs.gen(0)
    if not timing_only:
        print("phase 4 (Kernel B vs plain):", flush=True)
        cs.phase_ffn(g)
        print("phase 9 (Kernel D forward and backward vs plain):", flush=True)
        cs.phase_ffn_train(g)
    print(f"timing, bf16, device time per call (order plain, kernel, kernel, plain) [{card}]:",
          flush=True)
    bf = torch.bfloat16
    for label, rows, c in TIMED:
        f = 192
        p = cs.ffn_params(c, f, g)
        x = cs.away_from_kink(cs.randn(rows, c, g=g, dtype=bf), p, g)
        cot = cs.randn(rows, c, g=g, dtype=bf)
        if label.endswith("eval"):
            with torch.no_grad():
                fns = {"B": (lambda: ffn_b.encoder_ffn_torch(x, *p),
                             lambda: ffn_b.encoder_ffn_fused(x, *p))}
        else:
            def tail(fn, rate):
                return lambda *a: fn(*a, dropout_rate=rate, dropout_seed=5, dropout_offset=0)

            fns = {}
            for rate in (cs.RATE, 0.0):
                fwd = [lambda fn=fn, rate=rate: tail(fn, rate)(x, *p)
                       for fn in (encoder_ffn_train_torch, encoder_ffn_train_fused)]
                bwd = [cs.backward_only(tail(fn, rate), (x, *p), cot)
                       for fn in (encoder_ffn_train_torch, encoder_ffn_train_fused)]
                fns[f"D forward, rate {rate}"] = fwd
                fns[f"D backward, rate {rate}"] = bwd
        for name, (plain, kernel) in fns.items():
            with torch.set_grad_enabled("backward" in name):
                dev = [cs.device_ms(fn, 20) for fn in (plain, kernel, kernel, plain)]
            print(f"  {label} rows={rows} C={c} {name}: kernel {(dev[1] + dev[2]) / 2 * 1e3:.1f} us, "
                  f"plain {(dev[0] + dev[3]) / 2 * 1e3:.1f} us ("
                  + ", ".join(f"{t * 1e3:.1f}" for t in dev) + ")", flush=True)
            with torch.set_grad_enabled("backward" in name):
                by_kernel(kernel, f"{label} {name}, kernels of one call")
    print("PROBE OK")


if __name__ == "__main__":
    main()
