"""Valid persons over person slots in a serve cell's traced stretch, in %:
the program's counters ``predictor.persons`` over ``predictor.slots`` (B x n
of every bucket call), the padding ``Predictor`` computes for nothing."""

from bench_h100.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    if snap is None or not snap["counters"].get("predictor.slots"):
        return None
    c = snap["counters"]
    return 100.0 * c.get("predictor.persons", 0) / c["predictor.slots"]
