"""First card check of kernel 9: build, the compiler's register and spill
report, forward and backward against the plain version at HRFormer-B's four
branch maps (P = 24 persons) and an odd map, f32 and bf16, a quick bf16
timing, and Kernels D and E again (their sources share code with kernel 9).

    python3 -m i2rnet_tpu_torch.probes.kernel9_probe    # from the repository root, on a card
"""

from __future__ import annotations

import time


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (window_attn_block_train_fused,
                                                                window_attn_block_train_torch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    t0 = time.time()
    so = build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s")
    for part in so.with_suffix(".log").read_text().split("== "):
        if part.startswith(("window_attn_block", "encoder_ffn_train")):
            lines = part.splitlines()
            print("\n".join([lines[0]] + [ln for ln in lines if "registers" in ln or "spill" in ln
                                          or "error" in ln.lower()]))
    g = cs.gen(0)
    names = ("out",) + cs.HRT_TRAIN_NAMES
    for p, h, w, c, heads in [(3, 7, 6, 24, 3), (24, 64, 48, 78, 2), (24, 32, 24, 156, 4),
                              (24, 16, 12, 312, 8), (24, 8, 6, 624, 16)]:
        ln, attn, _ = cs.hrt_kernel_args(c, heads, g)
        s = torch.tensor(([1.25, 0.0, 1.0, 1.25] * 8)[:p], device=cs.DEV)
        for dt in (torch.float32, torch.bfloat16):
            x = (2 * cs.randn(p, h, w, c, g=g)).to(dt)
            cot = cs.randn(p, h, w, c, g=g, dtype=dt)

            def run(fn):
                return cs.fwd_bwd(lambda x_, *prm: fn(x_, s, *prm, heads=heads), (x, *ln, *attn),
                                  cot)

            (ok, gk), (op, gp) = run(window_attn_block_train_fused), run(window_attn_block_train_torch)
            torch.cuda.synchronize()
            rels = {}
            for n, a, r in zip(names, (ok, *gk), (op, *gp)):
                scale = (gp[4] if n == "bk" else r).float().abs().max().clamp_min(1e-30)
                rels[n] = ((a.float() - r.float()).abs().max() / scale).item()
            same0 = torch.equal(ok[1], x[1]) and torch.equal(gk[0][1], cot[1])
            print((p, h, w, c, heads), str(dt)[6:], "s=0 exact", same0,
                  " ".join(f"{k} {v:.2e}" for k, v in rels.items()), flush=True)
            if dt == torch.bfloat16 and p == 24:
                def call(fn):
                    return lambda *a: fn(a[0], s, *a[1:], heads=heads)

                with torch.no_grad():
                    tp, tk = cs.alternate(lambda: call(window_attn_block_train_torch)(x, *ln, *attn),
                                          lambda: call(window_attn_block_train_fused)(x, *ln, *attn),
                                          5)
                tbp, tbk = cs.alternate(
                    cs.backward_only(call(window_attn_block_train_torch), (x, *ln, *attn), cot),
                    cs.backward_only(call(window_attn_block_train_fused), (x, *ln, *attn), cot), 5)
                print(f"   timing bf16: fwd kernel {tk * 1e3:.1f} us plain {tp * 1e3:.1f} us; "
                      f"bwd kernel {tbk * 1e3:.1f} us plain {tbp * 1e3:.1f} us", flush=True)
    print("phase 9 (Kernel D):")
    cs.phase_ffn_train(g)
    print("phases 12-14 (E):")
    cs.phase_hrt_kernels(g)
    print("PROBE OK")


if __name__ == "__main__":
    main()
