"""Host time of ``Predictor.pack`` a bucket call in a serve cell's traced
stretch, in ms: the mean self time of the program's ``predictor.pack`` spans
(canvas zero-fill, images copied in, the person math), their
``predictor.h2d`` child (the copies to the device) left out."""

from bench_h100.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    if snap is None:
        return None
    packs = program_spans.spans(snap, "predictor.pack")
    if not packs:
        return None
    child = {}
    for s in program_spans.spans(snap, "predictor.h2d"):
        child[s["parent"]] = child.get(s["parent"], 0) + s["end_ns"] - s["start_ns"]
    own = [p["end_ns"] - p["start_ns"] - child.get(p["id"], 0) for p in packs]
    return sum(own) / len(own) / 1e6
