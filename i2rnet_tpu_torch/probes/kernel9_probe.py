"""First card check of kernel 9's backward (``csrc/window_attn_block_train.cu``):
build, each of its kernels' registers and spills from the compiler's report,
the tensor-core instructions (``HMMA``) in the SASS of the bf16 kernels (pass
1, pass 2, the weight gradients) and of the f32 template, the bf16
backward's plan at every map of ``chip_smoke.HRT_TRAIN_SHAPES``; then phase
17's checks (forward and backward against the plain version, f32 and bf16,
s = 0 exact, two bf16 backward calls bit-equal); and last the backward per
branch of a 256x192 input (bf16, P=24): device time per call beside the
plain version's, with the kernels it launches.

    python3 -m i2rnet_tpu_torch.probes.kernel9_probe [--timing]   # repository root, on a card

``--timing`` skips the checks.
"""

from __future__ import annotations

import sys
import time

from i2rnet_tpu_torch.probes.mlp_probe import hmma_counts

#: the backward's bf16 kernels and the f32 template's K1, as their SASS names them
KERNEL_NAMES = ("attn_bwd_mma_kernel", "dt2_mma_kernel", "dw_mma_kernel", "attn_bwd_kernel")


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (attn_bwd_plan,
                                                                window_attn_block_train_fused,
                                                                window_attn_block_train_torch)
    from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import sm_count
    from i2rnet_tpu_torch.probes.mhsa_probe import by_kernel, kernel_resources

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.time()
    so = build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s", flush=True)
    for src, name, regs, st, ld in kernel_resources(so.with_suffix(".log").read_text(),
                                                    ("window_attn_block_train.cu",)):
        print(f"  {src:28s} {name:60s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
    for name, n in hmma_counts(so, KERNEL_NAMES).items():
        print(f"  SASS {name[:90]}: {n} HMMA", flush=True)
    for shape in cs.HRT_TRAIN_SHAPES:
        print(f"  plan {shape} bf16: {cs.bwd_plan_text(attn_bwd_plan(*shape, sm_count(0)))}",
              flush=True)
    g = cs.gen(0)
    if "--timing" not in sys.argv:
        print("phase 17 (kernel 9 forward and backward vs plain):", flush=True)
        cs.phase_hrt_train_kernels(g)
    print(f"timing, bf16 backward, device time per call [{card}]:", flush=True)
    for shape in cs.HRT_TRAIN_SHAPES[:4]:
        p, h, w, c, heads = shape
        ln, attn, _ = cs.hrt_kernel_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        cot = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        s = torch.full((p,), 1.25, device=cs.DEV)

        def call(fn):
            return lambda x_, *prm: fn(x_, s, *prm, heads=heads)

        plain, kernel = (cs.backward_only(call(fn), (x, *ln, *attn), cot)
                         for fn in (window_attn_block_train_torch, window_attn_block_train_fused))
        dev = [cs.device_ms(f, 10) for f in (plain, kernel, kernel, plain)]
        bound = cs.hrt_train_bound(shape, torch.bfloat16, True)
        print(f"  {shape}: kernel {(dev[1] + dev[2]) / 2 * 1e3:.1f} us, plain "
              f"{(dev[0] + dev[3]) / 2 * 1e3:.1f} us (order plain, kernel, kernel, plain: "
              + ", ".join(f"{t * 1e3:.1f}" for t in dev)
              + f"), bound {bound[0] * 1e3:.2f} us ({bound[1]})", flush=True)
        by_kernel(kernel, f"{shape} kernels of one backward call")
    print("PROBE OK")


if __name__ == "__main__":
    main()
