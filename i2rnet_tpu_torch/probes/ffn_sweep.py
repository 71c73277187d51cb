"""What bounds the FFN tail's bf16 body (``csrc/ffn_tile.cuh``): Kernels B and
D with a part of their work swapped out, timed at the main-path shapes in one
call.

Builds variants of the package in copies under ``.local/ffn_sweep/``
(gitignored), each with ``csrc/ffn_tile.cuh`` (or the plan) edited and only
the widths C = 78, 96 instantiated, and prints for each B's and D's device
time per call (bf16, F = 192, D in seed mode at rate 0.1 and with dropout
off), summed per step as the W48 and HRT steps make the calls, and B's max
|error| / max |ref| against the plain version. The variants:

- ``shipped``: the source as it is;
- ``64-row tiles``: block b's warps take the four units of tile b (then of
  tile b + grid), the grids a block per tile;
- ``one block per SM``: the plan's grids at one block per SM;
- ``32 rows ahead``: the weight copy with twice the loads in flight;
- ``no weight copy``: the weights not copied into shared memory (wrong
  values: the time of the copy);
- ``no products``: the two products' mma.sync left out, their fragments
  still read (wrong values: what the tensor-core work costs).

    python3 -m i2rnet_tpu_torch.probes.ffn_sweep [variant ...]   # repository root, on a card
"""

from __future__ import annotations

import sys

from i2rnet_tpu_torch.probes.mlp_sweep import REPO, run_variants

OUT = REPO / ".local" / "ffn_sweep"
WIDTHS = """    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    case 64: return fn(std::integral_constant<int, 64>{});
"""
WIDE = """    case 112: return fn(std::integral_constant<int, 112>{});
    case 128: return fn(std::integral_constant<int, 128>{});
"""
WIDER = """    case 176: return fn(std::integral_constant<int, 176>{});
    case 192: return fn(std::integral_constant<int, 192>{});
    case 256: return fn(std::integral_constant<int, 256>{});
"""
COPY = """  copy_rounded(s.w1, CP + 8, fp, CP, p.w1, f, c);
  copy_rounded(s.w2, fp + 8, CP, fp, p.w2, c, f);
"""
MMA1 = """      amma::mma(h[2 * np], na[kk], kb[0], kb[1]);
      amma::mma(h[2 * np + 1], na[kk], kb[2], kb[3]);"""
MMA2 = """      amma::mma(y[2 * np], af[kk], kb[0], kb[1]);
      amma::mma(y[2 * np + 1], af[kk], kb[2], kb[3]);"""
UNITS = "for (long u = blockIdx.x + (long)gridDim.x * warp; u < units;"
TILES = "for (long u = (long)blockIdx.x * kTileWarps + warp; u < units;"
#: the files the variants edit
FILES = ("csrc/ffn_tile.cuh", "csrc/encoder_ffn_train.cu", "ops/cuda/encoder_ffn.py")
#: every variant builds only the widths of the main path (a shorter build)
TRIM = [(WIDTHS, ""), (WIDE, ""), (WIDER, "")]
#: name: [(text of a file below, its replacement)]
VARIANTS = {
    "shipped": TRIM,
    "64-row tiles": TRIM + [(UNITS, TILES),  # the forward's and pass 1's walks
                            ("min(units, (2 if fwd", "min(-(-units // 4), (2 if fwd"),
                            ("min(units, (2 if bwd", "min(-(-units // 4), (2 if bwd")],
    "one block per SM": TRIM + [("TWO_PER_SM = 113 * 1024", "TWO_PER_SM = 0")],
    "32 rows ahead": TRIM + [("constexpr int kRowsAhead = 16;", "constexpr int kRowsAhead = 32;")],
    "no weight copy": TRIM + [(COPY, "")],
    "no products": TRIM + [
        (MMA1, "      h[2 * np][0] += __uint_as_float(kb[0] ^ kb[1] ^ na[kk][0]);\n"
               "      h[2 * np + 1][0] += __uint_as_float(kb[2] ^ kb[3]);"),
        (MMA2, "      y[2 * np][0] += __uint_as_float(kb[0] ^ kb[1] ^ af[kk][0]);\n"
               "      y[2 * np + 1][0] += __uint_as_float(kb[2] ^ kb[3]);")],
}
#: (label, rows, C, calls per step) of B, then of D (forward and backward each)
B_SHAPES = (("W48 eval", 16 * 1344, 96, 12), ("HRT eval", 8 * 768, 78, 4))
D_SHAPES = (("W48 train", 8 * 1344, 96, 6), ("HRT train", 12 * 384, 78, 2))


def time_variant(name: str) -> None:
    """Run inside a variant's directory: B's error, B's and D's device time."""
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused, encoder_ffn_torch
    from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import encoder_ffn_train_fused

    build.sources = lambda: [build.CSRC / n for n in ("encoder_ffn.cu", "encoder_ffn_train.cu",
                                                      "encoder_ffn_train_wide.cu")]
    build.SIGNATURES = {k: build.SIGNATURES[k] for k in
                        ("i2r_encoder_ffn_fwd", "i2r_ffn_train_fwd", "i2r_ffn_train_bwd")}
    build.library()
    g = cs.gen(0)
    bf, f = torch.bfloat16, 192
    for label, rows, c, n in B_SHAPES:
        p = cs.ffn_params(c, f, g)
        x = cs.randn(rows, c, g=g, dtype=bf)
        with torch.no_grad():
            got = encoder_ffn_fused(x, *p).float()
            ref = encoder_ffn_torch(x, *p).float()
            ms = cs.device_ms(lambda: encoder_ffn_fused(x, *p), 20)
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        print(f"  {name} {label} B rows={rows} C={c}: {ms * 1e3:.1f} us device per call, "
              f"{n * ms:.3f} ms per step; max|err|/max|ref| {rel:.3g}", flush=True)
    for label, rows, c, n in D_SHAPES:
        p = cs.ffn_params(c, f, g)
        x = cs.away_from_kink(cs.randn(rows, c, g=g, dtype=bf), p, g)
        cot = cs.randn(rows, c, g=g, dtype=bf)
        for rate in (cs.RATE, 0.0):
            def tail(*a, rate=rate):
                return encoder_ffn_train_fused(*a, dropout_rate=rate, dropout_seed=5)

            with torch.no_grad():
                fwd = cs.device_ms(lambda: tail(x, *p), 20)
            bwd = cs.device_ms(cs.backward_only(tail, (x, *p), cot), 20)
            print(f"  {name} {label} D rows={rows} C={c} rate {rate}: forward {fwd * 1e3:.1f}, "
                  f"backward {bwd * 1e3:.1f} us device per call, {n * (fwd + bwd):.3f} ms per step",
                  flush=True)
    print(f"  {name} [{cs.card_line()}]", flush=True)


def main(names) -> None:
    run_variants(names, VARIANTS, FILES, "i2rnet_tpu_torch.probes.ffn_sweep", OUT)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2])
    else:
        main(sys.argv[1:])
