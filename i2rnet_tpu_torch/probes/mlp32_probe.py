"""First card check of Kernel G's tensor-core body (``csrc/mlp_dwbn.cuh::
mlp_item_tf32x3``: MlpDWBN alone, both products in three TF32 passes):
build, each kernel's registers and spills from the compiler's report, the
tensor-core instructions (``HMMA``) in the SASS of G's kernels, G's launch
plans at 256x192's four branch maps (P=32); then ``chip_smoke.py``'s phases
12-14 (E, F and G against their plain versions at every map, f32 and bf16;
two f32 calls of G bit-equal); and last G per branch map in f32 (its path's
dtype) as device time per call beside its plain version, with the kernels
each call launches, and G under other plans of the same body (one slice, or
smaller tiles that keep two blocks per SM).

    python3 -m i2rnet_tpu_torch.probes.mlp32_probe [--timing]   # repository root, on a card

``--timing`` skips the build report and the checks. Run from another checkout
(``PYTHONPATH=<tree> python3 <this file> --timing`` in that tree's root) it
times that tree's G with the same calls, so two versions compare in one card
call; a tree without G's TF32 body gets its weights in the f32 layout of the
CUDA-core template it runs.
"""

from __future__ import annotations

import sys
import time

#: G's kernels as their SASS names them: the body and the slices' sum
KERNEL_NAMES = ("mlp32_kernel", "mlp32_finish_kernel")
#: other plans (th, tw, slices) timed beside the shipped one, by branch map
#: C: one slice at one or two blocks per SM, and 8x8-evened tiles at one block
OTHER_PLANS = {78: ((8, 8, 1), (8, 4, 1)), 156: ((8, 8, 2),), 312: ((8, 6, 3), (4, 6, 5))}


def packed_weights(mod, args, device):
    """G's weights packed once, as the model keeps them: the TF32 fragments
    of this tree, or an earlier tree's f32 layout."""
    import torch

    if hasattr(mod, "pack_mlp32"):
        return mod.pack_mlp32(*args, device)
    return mod.pack_mlp(*args, torch.float32, device)


def plan_call(mod, build, x, args, packed, th, tw, slices):
    """A call of G's entry point under the plan (th, tw, slices), or None
    where the body does not take it."""
    import torch

    p, h, w, c = x.shape
    d = args[0].shape[0]
    out = torch.empty_like(x)
    part = torch.empty(slices * x.numel() if slices > 1 else 0, device=x.device)
    lib, stream = build.library(), torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.i2r_mlp_dwbn_fwd(x.data_ptr(), *(t.data_ptr() for t in packed), out.data_ptr(),
                                   part.data_ptr(), p, h, w, c, d, th, tw, slices,
                                   mod.DTYPE_CODES[x.dtype], stream)
        build.check(err, "mlp_dwbn kernel")
        return out

    try:
        call()
    except RuntimeError:
        return None
    return call


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda import mlp_dwbn as mod
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
    tf32 = hasattr(mod, "mlp32_plan")
    if not timing_only:
        for src, name, regs, st, ld in kernel_resources(so.with_suffix(".log").read_text(),
                                                        ("mlp_dwbn.cu",)):
            print(f"  {src:14s} {name:60s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
        for name, n in hmma_counts(so, KERNEL_NAMES + ("mlp_kernel",)).items():
            print(f"  SASS {name[:100]}: {n} HMMA", flush=True)
    if tf32:
        for shape in cs.HRT_SHAPES[:4]:
            p, h, w, c, _ = shape
            plan = mod.mlp32_plan(p, h, w, c, 4 * c, mod.sm_count(0))
            print(f"  plan {shape}: G {cs.plan_text(plan)}", flush=True)
    g = cs.gen(0)
    if not timing_only:
        print("phases 12-14 (E, F, G vs plain; G twice bit-equal):", flush=True)
        cs.phase_hrt_kernels(g)
    f32 = torch.float32
    print(f"timing, G f32, P=32, device time per call (order plain, kernel, kernel, plain) "
          f"[{card}]:", flush=True)
    for shape in cs.HRT_SHAPES[:4]:
        p, h, w, c, heads = shape
        _, _, args = cs.hrt_kernel_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=f32)
        packed = packed_weights(mod, args, x.device)
        fns = (lambda: mod.mlp_dwbn_torch(x, *args),
               lambda: mod.mlp_dwbn_fused(x, *args, packed=packed))
        with torch.no_grad():
            dev = [cs.device_ms(fn, 10) for fn in (*fns, *fns[::-1])]
            b = cs.hrt_bound("mlp_dwbn", shape, f32) if tf32 else (float("nan"), "")
            print(f"  {shape}: G {(dev[1] + dev[2]) / 2 * 1e3:.1f} us, plain "
                  f"{(dev[0] + dev[3]) / 2 * 1e3:.1f} us ("
                  + ", ".join(f"{t * 1e3:.1f}" for t in dev)
                  + f"); bound {b[0] * 1e3:.2f} us ({b[1]})", flush=True)
            by_kernel(fns[1], f"G {shape}, kernels of one call")
            if not tf32:
                continue
            ref = mod.mlp_dwbn_torch(x, *args)
            for th, tw, slices in OTHER_PLANS.get(c, ()):
                call = plan_call(mod, build, x, args, packed, th, tw, slices)
                if call is None:
                    print(f"    plan {th}x{tw}, {slices} slice(s): not taken by the body")
                    continue
                rel = ((call() - ref).abs().max() / ref.abs().max()).item()
                smem = mod._mma32_smem(c, h, w, th, tw, 4 * c, slices)
                print(f"    plan {th}x{tw}, {slices} slice(s), {smem} B shared: "
                      f"{cs.device_ms(call, 10) * 1e3:.1f} us, max|err|/max|ref| {rel:.3g}",
                      flush=True)
    print("PROBE OK")


if __name__ == "__main__":
    main()
