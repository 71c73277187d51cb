"""What moves kernel 9's bf16 backward: the same kernels with one design step
undone or a part of their work left out, timed per branch in one call.

Builds variants of the package in copies under ``.local/attn_bwd_sweep/``
(gitignored), each with ``csrc/window_attn_block_train.cu`` or
``ops/cuda/hrformer_block_train.py`` edited, and
prints for each the backward's device time per call at 256x192's four
branch maps (bf16, P=24), its kernels' device times, the sum over one HRT
train step's 44 calls, and the backward's worst max |error| / max |ref|
against the plain version (``chip_smoke.HRT_TOL`` bf16 is 1e-2). The
variants:

- ``shipped``: the sources as they are;
- ``pass 1 3 blocks per SM``: pass 1 built for three resident blocks (at
  most 85 registers a thread; its shared memory fits three at branches 0-1);
- ``pass 2 up to 8 n-tiles a block``: pass 2's column blocks of up to 8
  n-tiles (one a warp) instead of 16 (two a warp);
- ``pass 2 fragments 1 ahead``: pass 2 reads Wqkv's fragments one k-step
  ahead instead of four;
- ``weight gradients 3 stages``: the weight gradients' cp.async ring of
  three stages (two in flight while one is multiplied) instead of two;
- ``no q/k/v products``, ``no attention products``: that part of pass 1
  left out (wrong values: what it costs).

    python3 -m i2rnet_tpu_torch.probes.attn_bwd_sweep [variant ...]   # repository root, on a card
"""

from __future__ import annotations

import sys

from i2rnet_tpu_torch.probes.mlp_sweep import REPO, run_variants

OUT = REPO / ".local" / "attn_bwd_sweep"
FILES = ("csrc/window_attn_block_train.cu", "ops/cuda/hrformer_block_train.py")
PASS1 = "__global__ void __launch_bounds__(kThreads, 2)\nattn_bwd_mma_kernel("
QKV = "    proj_mma(ts, ldc, wf + (size_t)hd * nt3 * ks1 * 32, ks1, nt3,"
ATTN = ("      if (kk * 16 < dp) {\n        uint32_t qa[4];",
        "      if (kk * 16 < dp) {\n        uint32_t da[4];",
        "      for (int kk = 0; kk < 4; ++kk) {\n        uint32_t pa[4];",
        "      for (int kk = 0; kk < 4; ++kk) {\n        uint32_t sa[4];\n        amma::acc_to_a",
        "      for (int kk = 0; kk < 4; ++kk) {\n        uint32_t sa[4], pa[4];")
#: name: [(text of one of FILES, its replacement)]
VARIANTS = {
    "shipped": [],
    "pass 1 3 blocks per SM": [(PASS1, PASS1.replace("kThreads, 2", "kThreads, 3"))],
    "pass 2 up to 8 n-tiles a block": [("splits = max(-(-ntiles // MAX_COLS),",
                                        "splits = max(-(-ntiles // 8),")],
    "pass 2 fragments 1 ahead": [("constexpr int kBAhead = 4;", "constexpr int kBAhead = 1;")],
    "weight gradients 3 stages": [("constexpr int kWStages = 2;", "constexpr int kWStages = 3;")],
    "no q/k/v products": [(QKV, QKV.replace("ks1, nt3,", "ks1, 0,"))],
    "no attention products": [
        *((t, t.replace("kk * 16 < dp", "kk * 16 < 0")) for t in ATTN[:2]),
        *((t, t.replace("kk < 4;", "kk < 0;")) for t in ATTN[2:])],
}
#: kernel 9's backward calls per HRT train step on branches 0-3
STEP_CALLS = (14, 14, 12, 4)


def time_variant(name: str) -> None:
    """Run inside a variant's directory: the backward's error and device time per branch."""
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (window_attn_block_train_fused,
                                                                window_attn_block_train_torch)
    from i2rnet_tpu_torch.probes.mhsa_probe import by_kernel

    # only kernel 9's sources: the variants differ there, and the rest take a minute to build
    build.sources = lambda: [build.CSRC / f for f in ("window_attn_block.cu",
                                                      "window_attn_block_train.cu")]
    build.SIGNATURES = {k: build.SIGNATURES[k] for k in ("i2r_window_attn_fwd",
                                                         "i2r_window_attn_train_fwd",
                                                         "i2r_window_attn_train_bwd")}
    build.library()
    g = cs.gen(0)
    total = 0.0
    for shape, n in zip(cs.HRT_TRAIN_SHAPES[:4], STEP_CALLS):
        p, h, w, c, heads = shape
        ln, attn, _ = cs.hrt_kernel_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        cot = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        s = torch.full((p,), 1.25, device=cs.DEV)

        def call(fn):
            return lambda x_, *prm: fn(x_, s, *prm, heads=heads)

        got, ref = (cs.backward_only(call(fn), (x, *ln, *attn), cot)()
                    for fn in (window_attn_block_train_fused, window_attn_block_train_torch))
        # dbk (index 6) is 0 in exact arithmetic: held against dbq's scale, as phase 17
        rel = max(((a.float() - r.float()).abs().max()
                   / ref[4 if i == 6 else i].float().abs().max()).item()
                  for i, (a, r) in enumerate(zip(got, ref)))
        kernel = cs.backward_only(call(window_attn_block_train_fused), (x, *ln, *attn), cot)
        ms = cs.device_ms(kernel, 10)
        total += n * ms
        print(f"  {name} {shape}: backward {ms * 1e3:.1f} us device per call, worst "
              f"max|err|/max|ref| {rel:.3g}", flush=True)
        by_kernel(kernel, f"{name} {shape} kernels")
    print(f"  {name}: summed over one HRT train step's 44 calls {total:.2f} ms "
          f"[{cs.card_line()}]", flush=True)


def main(names) -> None:
    run_variants(names, VARIANTS, FILES, "i2rnet_tpu_torch.probes.attn_bwd_sweep", OUT)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2])
    else:
        main(sys.argv[1:])
