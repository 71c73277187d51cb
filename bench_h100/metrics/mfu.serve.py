"""Model FLOP utilisation of a serve cell's measured window, in %: the
FLOPs of the valid persons' work (counted on the benchmark's reference at
the cell's shapes, ``flops.row_flops``) over the window's seconds times the
card's dense bf16 peak."""

from bench_h100.flops import PEAK_BF16


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * PEAK_BF16)
