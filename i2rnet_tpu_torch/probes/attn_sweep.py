"""What bounds Kernel E's bf16 body: the same kernels with a part of their
work swapped out, or another occupancy, timed per branch in one call.

Builds variants of the package in copies under ``.local/attn_sweep/``
(gitignored), each with ``csrc/window_attn.cuh``, ``csrc/window_attn_block.cu``
or ``ops/cuda/hrformer_block.py`` edited, and prints for each E's device time per
call at 256x192's four branch maps (bf16, P=32), summed over one HRT eval
step's 88 calls, and E's max |error| / max |ref| against the plain version
(``chip_smoke.HRT_TOL`` bf16 is 1e-2). The variants:

- ``shipped``: the sources as they are;
- ``2 blocks per SM``: pass 1 built for two resident blocks (at most 128
  registers a thread) also where three blocks' shared memory fits an SM
  (branches 0-2);
- ``no fusion``: pass 2 for the out-projection on every map, also where a
  block of pass 1 holds all heads (branches 0-1);
- ``no projection products``, ``no attention products``, ``no pass 2``:
  that part left out (wrong values: what it costs).

    python3 -m i2rnet_tpu_torch.probes.attn_sweep [variant ...]   # repository root, on a card
"""

from __future__ import annotations

import sys

from i2rnet_tpu_torch.probes.mlp_sweep import REPO, run_variants

OUT = REPO / ".local" / "attn_sweep"
THREE = "const bool three = b1 <= kThreePerSm;"
PROJ_MMA = "if (warp + kWarps * j < nt3) amma::mma(acc[j][mt], a, bk[j].x, bk[j].y);"
QK = "      if (kk * 16 < dp) {\n        uint32_t qa[4];"
PV = "        if (n < nd) {\n          uint32_t vb[2];"
PASS2 = "  attn_out_kernel<kTrain>\n      <<<"
FUSED = ("  const bool fused = group == heads;\n", "const bool fused = a.group == a.heads;",
         "        return self.group == self.heads")
FILES = ("csrc/window_attn.cuh", "csrc/window_attn_block.cu", "ops/cuda/hrformer_block.py")
#: name: [(text of window_attn.cuh or window_attn_block.cu, its replacement)]
VARIANTS = {
    "shipped": [],
    "2 blocks per SM": [(THREE, "const bool three = false;")],
    "no projection products": [(PROJ_MMA, PROJ_MMA.replace(
        "amma::mma(acc[j][mt], a, bk[j].x, bk[j].y);",
        "acc[j][mt][0] += __uint_as_float(a[0] ^ bk[j].x);"))],
    "no attention products": [(QK, QK.replace("kk * 16 < dp", "kk * 16 < 0")),
                              (PV, PV.replace("n < nd", "n < 0"))],
    "no pass 2": [(PASS2, "  if (false) " + PASS2.lstrip())],
    "no fusion": [(FUSED[0], "  const bool fused = false;\n"),
                  (FUSED[1], "const bool fused = false;"), (FUSED[2], "        return False")],
}


def time_variant(name: str) -> None:
    """Run inside a variant's directory: E's error and device time per branch."""
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block import (pack_attn, window_attn_block_fused,
                                                          window_attn_block_torch)

    # only E's source: the variants differ there, and the other kernels' build takes a minute
    build.sources = lambda: [build.CSRC / "window_attn_block.cu"]
    build.SIGNATURES = {k: build.SIGNATURES[k] for k in ("i2r_window_attn_fwd",
                                                         "i2r_window_attn_train_fwd")}
    build.library()
    g = cs.gen(0)
    total = 0.0
    for shape, n in zip(cs.HRT_SHAPES[:4], (28, 28, 24, 8)):  # E's calls per HRT eval step
        p, h, w, c, heads = shape
        ln, attn, _ = cs.hrt_kernel_args(c, heads, g)
        x = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        packed = pack_attn(*attn, heads, torch.bfloat16, x.device)
        with torch.no_grad():
            got = window_attn_block_fused(x, *ln, *attn, heads=heads, packed=packed).float()
            ref = window_attn_block_torch(x, *ln, *attn, heads).float()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            ms = cs.device_ms(lambda: window_attn_block_fused(x, *ln, *attn, heads=heads,
                                                              packed=packed), 10)
        total += n * ms
        print(f"  {name} {shape}: E {ms * 1e3:.1f} us device per call, max|err|/max|ref| "
              f"{rel:.3g}", flush=True)
    print(f"  {name}: summed over one HRT eval step's 88 calls {total:.2f} ms [{cs.card_line()}]",
          flush=True)


def main(names) -> None:
    run_variants(names, VARIANTS, FILES, "i2rnet_tpu_torch.probes.attn_sweep", OUT)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2])
    else:
        main(sys.argv[1:])
