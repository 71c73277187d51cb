"""First card check of kernel 7 (``csrc/full_block.cu``): build, the
compiler's register, shared-memory and spill report for it and for the
sources whose bodies it shares, the cooperative grid it gets at C=78 and
C=624, kernel 7 against its plain version and against Kernel E then Kernel F
at every map of ``chip_smoke.HRT_SHAPES`` (f32 and bf16), a quick bf16 timing
beside E then F, then Kernels E, F, G and kernel 9 against their plain
versions again (their bodies moved into the shared headers).

    python3 -m i2rnet_tpu_torch.probes.kernel7_probe    # from the repository root, on a card
"""

from __future__ import annotations

import time


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block import (full_block_fused, mlp_block_fused,
                                                          window_attn_block_fused)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    t0 = time.time()
    so = build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s")
    for part in so.with_suffix(".log").read_text().split("== "):
        if part.startswith(("full_block", "window_attn_block.cu", "mlp_dwbn")):
            lines = part.splitlines()
            print("\n".join([lines[0]] + [ln for ln in lines if "Compiling entry" in ln
                                          or "registers" in ln or "spill" in ln
                                          or "error" in ln.lower()]))
    for shape in ((32, 64, 48, 78, 2), (32, 8, 6, 624, 16)):
        for dt in (torch.float32, torch.bfloat16):
            per_sm, grid, smem, th, tw, slices = cs.kernel7_plan(shape, dt)
            print(f"plan {shape} {str(dt)[6:]}: {per_sm} blocks per SM, grid {grid}, "
                  f"{smem} B shared, MLP phase {th}x{tw} tiles, {slices} hidden slice(s)",
                  flush=True)
    g = cs.gen(0)
    print("kernel 7 vs plain and vs E then F:", flush=True)
    err, diff = cs.phase_full_block(g)
    print(f"  main-map bf16 error {err:.3g}; largest difference from E then F {diff:.3g}")
    for shape in cs.HRT_SHAPES[:4]:
        p, h, w, c, heads = shape
        args = cs.full_block_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        with torch.no_grad():
            ms, two = cs.in_turns([
                lambda: full_block_fused(x, *args, heads=heads),
                lambda: mlp_block_fused(window_attn_block_fused(x, *args[:10], heads=heads),
                                        *args[10:])], 5)
        print(f"  timing {shape} bf16: kernel 7 {ms * 1e3:.1f} us, E then F {two * 1e3:.1f} us",
              flush=True)
    print("phases 12-14 (E, F, G):", flush=True)
    cs.phase_hrt_kernels(g)
    print("phase 17 (kernel 9):", flush=True)
    cs.phase_hrt_train_kernels(g)
    print("PROBE OK")


if __name__ == "__main__":
    main()
