"""Device time of the trunk (the HRNet stages and the 1x1 reduce; both flip
passes) a person slot in a serve cell's traced stretch, in us: the
program's ``model.trunk`` spans over ``predictor.slots``."""

from bench_h100.metrics import program_spans


def read(ctx):
    return program_spans.per_slot_us(ctx, "model.trunk")
