"""Device time of the crop warp and position masks (``ops/preprocess.py``) a
person slot in a serve cell's traced stretch, in us: the program's
``serve.preprocess`` spans over ``predictor.slots``."""

from bench_h100.metrics import program_spans


def read(ctx):
    return program_spans.per_slot_us(ctx, "serve.preprocess")
