"""First card check of the tensor-core Kernels A and C: build, each kernel's
registers and spills from the compiler's report, Kernel A and Kernel C's
forward and backward against their plain versions at every shape and mask of
``chip_smoke.py`` phases 3 and 8 (f32 and bf16), each kernel's device time
per launch from ``torch.profiler``, and their bf16 times at the main-path
shapes beside SDPA (phases 7 and 11's kernel timing).

    python3 -m i2rnet_tpu_torch.probes.mhsa_probe [--timing]   # repository root, on a card

``--timing`` skips the checks.
"""

from __future__ import annotations

import re
import sys
import time


def kernel_resources(log: str, sources=("mhsa.cu", "mhsa_train.cu")):
    """(source, kernel, registers, spill store bytes, spill load bytes) of
    each kernel that ``ptxas -v`` reports for ``sources``."""
    rows = []
    for part in log.split("== ")[1:]:
        src = part.splitlines()[0].strip()
        if src not in sources:
            continue
        name, spills = None, (0, 0)
        for line in part.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                short = re.sub(r"^_ZN\d*_GLOBAL__N_\w*?\d+", "", name)
                rows.append((src, short[:60], int(m.group(1)), *spills))
                name = None
    return rows


def by_kernel(fn, what, iters=10):
    """Device ms per call of each kernel that ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "#" not in e.name:
            times[e.name[:70]] = times.get(e.name[:70], 0.0) + e.time_range.elapsed_us() / iters
    print(f"  {what}: " + "; ".join(f"{n} {t:.1f} us" for n, t in
                                    sorted(times.items(), key=lambda kv: -kv[1])), flush=True)


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.time()
    so = build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s", flush=True)
    for src, name, regs, st, ld in kernel_resources(so.with_suffix(".log").read_text()):
        print(f"  {src:14s} {name:60s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
    g = cs.gen(0)
    if "--timing" not in sys.argv:
        print("phase 3 (Kernel A vs plain):", flush=True)
        cs.phase_mhsa(g)
        print("phase 8 (Kernel C vs plain):", flush=True)
        cs.phase_mhsa_train(g)
    print(f"timing [{card}]:", flush=True)
    from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused
    from i2rnet_tpu_torch.ops.cuda.mhsa_train import masked_mhsa_train_fused
    b, s, c = 16, 1344, 96
    q, k, v = (cs.randn(b, s, c, g=g, dtype=torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        for kind, mask in (("ragged", cs.ragged_mask(b, s, 192, g)), ("no", None)):
            by_kernel(lambda: masked_mhsa_fused(q, k, v, 1, mask), f"A, {kind} mask")
    b = 8
    q, k, v, cot = (cs.randn(b, s, c, g=g, dtype=torch.bfloat16) for _ in range(4))
    mask = cs.ragged_mask(b, s, 192, g)

    def attn(q_, k_, v_):
        return masked_mhsa_train_fused(q_, k_, v_, 1, mask, cs.RATE, dropout_seed=5)

    with torch.no_grad():
        by_kernel(lambda: attn(q, k, v), "C fwd, ragged mask, seed")
        by_kernel(lambda: masked_mhsa_train_fused(q, k, v, 1, None, 0.0), "C fwd, no mask, rate 0")
    by_kernel(cs.backward_only(attn, (q, k, v), cot), "C bwd, ragged mask, seed")
    cs.phase_timing_mhsa(g, card)
    cs.phase_train_kernel_timing(g, card)
    print("PROBE OK")


if __name__ == "__main__":
    main()
