"""Register and occupancy sweep of kernel 7 (``csrc/full_block.cu``).

Builds six variants of the kernel in copies of the package under
``.local/kernel7_sweep/`` (gitignored): its phases inlined into the
kernel or not, and ``__launch_bounds__`` asking for no minimum, 2 or 3
blocks per SM (registers left to ptxas, capped at 128, capped at 80). Each
variant prints ptxas' register and spill report and times kernel 7 against
Kernel E then Kernel F at HRFormer-B's four branch maps (bf16, P=32), checks
that the two agree bit for bit, and sums both over one eval step's blocks
(28, 28, 24 and 8 on branches 0-3). The shipped kernel is "noinline, 2".

    python3 -m i2rnet_tpu_torch.probes.kernel7_sweep    # from the repository root, on a card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / ".local" / "kernel7_sweep"
SHIPPED = ("__device__ __noinline__ void", "__launch_bounds__(kThreads, 2)\nfull_block_kernel")
#: blocks per HRT eval step on branches 0-3 (two forwards of 14, 14, 12, 4)
STEP_BLOCKS = (28, 28, 24, 8)


def variant_source(src: str, inline: bool, min_blocks: int) -> str:
    for pattern in SHIPPED:
        if pattern not in src:
            raise RuntimeError(f"full_block.cu no longer has {pattern!r}")
    if inline:
        src = src.replace(SHIPPED[0], "__device__ __forceinline__ void")
    bounds = f"kThreads, {min_blocks}" if min_blocks else "kThreads"
    return src.replace(SHIPPED[1], f"__launch_bounds__({bounds})\nfull_block_kernel")


def time_variant(name: str) -> None:
    """Run inside a variant's directory: report and timing of its kernel 7."""
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block import (full_block_fused, mlp_block_fused,
                                                          window_attn_block_fused)

    so = build.build()
    build.library()
    part = so.with_suffix(".log").read_text().split("== full_block.cu")[1].split("== ")[0]
    report = [ln.strip() for ln in part.splitlines() if "Used" in ln or "spill" in ln]
    print(f"{name} | " + " ; ".join(report[:4]), flush=True)
    g = cs.gen(0)
    total7 = total2 = 0.0
    for shape, n in zip(cs.HRT_SHAPES[:4], STEP_BLOCKS):
        p, h, w, c, heads = shape
        args = cs.full_block_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)

        def two_kernels():
            return mlp_block_fused(window_attn_block_fused(x, *args[:10], heads=heads), *args[10:])

        with torch.no_grad():
            if not torch.equal(full_block_fused(x, *args, heads=heads), two_kernels()):
                raise AssertionError(f"{name} {shape}: kernel 7 differs from E then F")
            ms7, ms2 = cs.in_turns([lambda: full_block_fused(x, *args, heads=heads), two_kernels],
                                   5)
        total7, total2 = total7 + n * ms7, total2 + n * ms2
        per_sm, grid, smem, *_ = cs.kernel7_plan(shape, torch.bfloat16)
        print(f"  {name} {shape}: kernel 7 {ms7 * 1e3:.1f} us, E then F {ms2 * 1e3:.1f} us, "
              f"{per_sm} blocks/SM, grid {grid}, {smem} B shared", flush=True)
    print(f"  {name} summed over one eval step's blocks: kernel 7 {total7:.1f} ms, E then F "
          f"{total2:.1f} ms [{cs.card_line()}]", flush=True)


def main() -> None:
    src = (REPO / "i2rnet_tpu_torch" / "csrc" / "full_block.cu").read_text()
    failed = []
    for inline in (False, True):
        for min_blocks in (0, 2, 3):
            name = f"{'inline' if inline else 'noinline'}, {min_blocks or 'no'} min blocks"
            d = OUT / f"{'inline' if inline else 'noinline'}_{min_blocks}"
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(REPO / "i2rnet_tpu_torch", d / "i2rnet_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy(REPO / "chip_smoke.py", d / "chip_smoke.py")
            (d / "i2rnet_tpu_torch" / "csrc" / "full_block.cu").write_text(
                variant_source(src, inline, min_blocks))
            env = {**os.environ, "PYTHONPATH": str(d)}
            proc = subprocess.run([sys.executable, "-m", "i2rnet_tpu_torch.probes.kernel7_sweep",
                                   "--time", name], cwd=d, env=env, timeout=600)
            if proc.returncode != 0:
                failed.append(name)
    if failed:
        raise SystemExit(f"variants failed: {failed}")
    print("SWEEP OK")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2])
    else:
        main()
