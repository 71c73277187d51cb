"""First card check of Kernel E's bf16 tensor-core body (``csrc/window_attn.cuh``),
which kernel 9's forward and kernel 7's attention phases run too: build, each
kernel's registers and spills from the compiler's report, the tensor-core
instructions (``HMMA``) in the SASS of E's two bf16 kernels and of kernel 7,
E's launch plan at every map of ``chip_smoke.HRT_SHAPES``; then Kernel E
against its plain version there (f32 and bf16; ``chip_smoke.py`` phases
12-14), kernel 9 forward and backward (phase 17) and kernel 7 against its
plain version and E then F (phase 20); and last E per branch of a 256x192
input (bf16, P=32) and kernel 9's forward (P=24): device time per call with
the kernels it launches, the plain version's, and CUDA events.

    python3 -m i2rnet_tpu_torch.probes.attn_probe [--timing] [--quick]   # repository root, on a card

``--timing`` skips the checks; ``--quick`` runs only E's check (phases
12-14) after the build and stops.
"""

from __future__ import annotations

import sys
import time

from i2rnet_tpu_torch.probes.mlp_probe import hmma_counts

#: E's bf16 kernels, kernel 7 and E's f32 template, as their SASS names them
KERNEL_NAMES = ("attn_mma_kernel", "attn_out_kernel", "full_block_kernel", "window_attn_kernel")


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block import (attn_plan, pack_attn,
                                                          window_attn_block_fused,
                                                          window_attn_block_torch)
    from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (window_attn_block_train_fused,
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
                                                    ("window_attn_block.cu", "full_block.cu")):
        print(f"  {src:20s} {name:60s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
    for name, n in hmma_counts(so, KERNEL_NAMES).items():
        print(f"  SASS {name[:90]}: {n} HMMA", flush=True)
    for shape in cs.HRT_SHAPES:
        print(f"  plan {shape} bf16: E {cs.attn_plan_text(attn_plan(*shape, sm_count(0)))}; "
              f"kernel 7 {cs.kernel7_plan(shape, torch.bfloat16)}", flush=True)
    g = cs.gen(0)
    if "--timing" not in sys.argv:
        print("phases 12-14 (E, F, G vs plain):", flush=True)
        cs.phase_hrt_kernels(g)
        if "--quick" in sys.argv:
            print("PROBE OK")
            return
        print("phase 17 (kernel 9 forward and backward vs plain):", flush=True)
        cs.phase_hrt_train_kernels(g)
        print("phase 20 (kernel 7 vs plain and vs E then F):", flush=True)
        err, diff = cs.phase_full_block(g)
        print(f"  main-map bf16 error {err:.3g}; largest difference from E then F {diff:.3g}")
    bf = torch.bfloat16
    print(f"timing, bf16 [{card}]:", flush=True)
    for shape in cs.HRT_SHAPES[:4]:
        p, h, w, c, heads = shape
        ln, attn, _ = cs.hrt_kernel_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=bf)
        packed = pack_attn(*attn, heads, bf, x.device)
        fns = {"E plain": lambda: window_attn_block_torch(x, *ln, *attn, heads),
               "E": lambda: window_attn_block_fused(x, *ln, *attn, heads=heads, packed=packed)}
        with torch.no_grad():
            host = dict(zip(fns, cs.in_turns(list(fns.values()), 10)))
            dev = {k: cs.device_ms(f, 10) for k, f in fns.items()}
            bound = cs.hrt_bound("window_attn_block", shape, bf)[0]
            print(f"  E {shape}: " + ", ".join(f"{k} {dev[k] * 1e3:.1f} us device / "
                                                f"{host[k] * 1e3:.1f} us events" for k in fns)
                  + f"; bound {bound * 1e3:.2f} us [{card}]", flush=True)
            by_kernel(fns["E"], f"E {shape} by kernel")
        p = cs.HRT_TRAIN_SHAPES[0][0]
        s = torch.full((p,), 1.25, device=cs.DEV)
        xt = x[:p].contiguous()
        fns = {"kernel 9 fwd plain": lambda: window_attn_block_train_torch(xt, s, *ln, *attn,
                                                                           heads),
               "kernel 9 fwd": lambda: window_attn_block_train_fused(xt, s, *ln, *attn,
                                                                     heads=heads)}
        with torch.no_grad():
            dev = {k: cs.device_ms(f, 10) for k, f in fns.items()}
        bound = cs.hrt_train_bound((p, h, w, c, heads), bf, False)[0]
        print(f"  kernel 9 forward {(p, h, w, c, heads)}: " + ", ".join(
            f"{k} {dev[k] * 1e3:.1f} us device" for k in fns) + f"; bound {bound * 1e3:.2f} us",
            flush=True)
    print("PROBE OK")


if __name__ == "__main__":
    main()
