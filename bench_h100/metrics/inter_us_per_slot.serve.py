"""Device time of the position embedding and the inter encoder (both flip
passes) a person slot in a serve cell's traced stretch, in us: the
program's ``model.inter`` spans over ``predictor.slots``."""

from bench_h100.metrics import program_spans


def read(ctx):
    return program_spans.per_slot_us(ctx, "model.inter")
