"""95th percentile, over the requests of a serve cell's traced stretch, of
each request's wait in ``serving.MicroBatcher``: from its ``submit`` to the
start of the ``Predictor.predict`` call that served it (the program's
``batcher.queue_wait`` spans), less the time in it of the batcher's
hand-overs of calls to ``predict`` (``batcher.handover``: whatever wraps
``predict``; in the traced stretch, the profiler starting inside the first
traced call, which every request of the stretch waits through)."""

import numpy as np

from bench_h100.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    if snap is None:
        return None
    handovers = [(s["start_ns"], s["end_ns"])
                 for s in program_spans.spans(snap, "batcher.handover")]
    waits = []
    for s in program_spans.spans(snap, "batcher.queue_wait"):
        a, b = s["start_ns"], s["end_ns"]
        outside = sum(max(0, min(b, y) - max(a, x)) for x, y in handovers)
        waits.append((b - a - outside) / 1e6)
    return float(np.percentile(waits, 95)) if waits else None
