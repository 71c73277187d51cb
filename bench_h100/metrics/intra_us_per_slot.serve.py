"""Device time of TransPose-H's intra encoder (with the first stage's own
final layer; both flip passes) a person slot in a serve cell's traced
stretch, in us: the program's ``model.intra`` spans over ``predictor.slots``."""

from bench_h100.metrics import program_spans


def read(ctx):
    return program_spans.per_slot_us(ctx, "model.intra")
