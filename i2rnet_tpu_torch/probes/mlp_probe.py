"""First card check of Kernel F's bf16 tensor-core body (``csrc/mlp_dwbn.cuh``)
and of kernel 7, which runs it in its second phase: build, each kernel's
registers and spills from the compiler's report, the tensor-core
instructions (``HMMA``) in their SASS, F's launch plan at every map of
``chip_smoke.HRT_SHAPES``, Kernels E, F, G and kernel 7 against their plain
versions there (f32 and bf16; ``chip_smoke.py`` phases 12-14 and 20), and F
and kernel 7 per branch of a 256x192 input (bf16, P=32): device time per
call with the kernels it launches, the plain version's, and CUDA events.

    python3 -m i2rnet_tpu_torch.probes.mlp_probe [--timing]   # repository root, on a card

``--timing`` skips the checks.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path


def hmma_counts(so: Path, names=("mlp_mma_kernel", "full_block_kernel", "mlp_kernel")):
    """{function: number of HMMA instructions} of the library's SASS for the
    functions whose names contain one of ``names``."""
    from i2rnet_tpu_torch.ops.cuda import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if any(n in m.group(1) for n in names) else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block import (full_block_fused, full_block_torch,
                                                          mlp_block_fused, mlp_block_torch,
                                                          pack_attn, window_attn_block_fused)
    from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import mlp_plan, pack_mlp, sm_count
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
                                                    ("mlp_dwbn.cu", "full_block.cu")):
        print(f"  {src:14s} {name:60s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
    for name, n in hmma_counts(so).items():
        print(f"  SASS {name[:90]}: {n} HMMA", flush=True)
    bf = torch.bfloat16
    for shape in cs.HRT_SHAPES:
        p, h, w, c, _ = shape
        print(f"  plan {shape} bf16: F {cs.plan_text(mlp_plan(p, h, w, c, 4 * c, sm_count(0)))}",
              flush=True)
        for dt in (torch.float32, bf):
            per_sm, grid, smem, th, tw, slices = cs.kernel7_plan(shape, dt)
            print(f"  plan {shape} {str(dt)[6:]}: kernel 7 grid {grid} ({per_sm} blocks per SM), "
                  f"{smem} B shared, MLP phase {th}x{tw} tiles, {slices} hidden slice(s)",
                  flush=True)
    g = cs.gen(0)
    if "--timing" not in sys.argv:
        print("phases 12-14 (E, F, G vs plain):", flush=True)
        cs.phase_hrt_kernels(g)
        print("phase 20 (kernel 7 vs plain and vs E then F):", flush=True)
        err, diff = cs.phase_full_block(g)
        print(f"  main-map bf16 error {err:.3g}; largest difference from E then F {diff:.3g}")
    print(f"timing, bf16, P=32 [{card}]:", flush=True)
    for shape in cs.HRT_SHAPES[:4]:
        p, h, w, c, heads = shape
        args = cs.full_block_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=bf)
        pa, pm = pack_attn(*args[2:10], heads, bf, x.device), pack_mlp(*args[12:], bf, x.device)
        fns = {"F plain": lambda: mlp_block_torch(x, *args[10:]),
               "F": lambda: mlp_block_fused(x, *args[10:], packed=pm),
               "kernel 7 plain": lambda: full_block_torch(x, *args, heads),
               "kernel 7": lambda: full_block_fused(x, *args, heads=heads, packed=(pa, pm)),
               "E then F": lambda: mlp_block_fused(window_attn_block_fused(
                   x, *args[:10], heads=heads, packed=pa), *args[10:], packed=pm)}
        with torch.no_grad():
            host = dict(zip(fns, cs.in_turns(list(fns.values()), 10)))
            dev = {k: cs.device_ms(f, 10) for k, f in fns.items()}
            times = ", ".join(f"{k} {dev[k] * 1e3:.1f} us device / {host[k] * 1e3:.1f} us events"
                              for k in fns)
            bound = cs.hrt_bound("mlp_block", shape, bf)[0]
            print(f"  {shape}: {times}; F bound {bound * 1e3:.2f} us [{card}]", flush=True)
            by_kernel(fns["F"], f"F {shape} by kernel")
            by_kernel(fns["kernel 7"], f"kernel 7 {shape} by kernel")
    print("PROBE OK")


if __name__ == "__main__":
    main()
