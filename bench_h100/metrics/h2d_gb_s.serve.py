"""Rate of the input copy in a serve cell's traced stretch, in GB/s: the
program's ``predictor.h2d_bytes`` (the seven arrays of every bucket call)
over the device time of its ``predictor.h2d`` spans."""

from bench_h100.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    if snap is None:
        return None
    t = program_spans.device_seconds(snap, "predictor.h2d")
    moved = snap["counters"].get("predictor.h2d_bytes")
    if not t or not moved:
        return None
    return moved / t / 1e9
