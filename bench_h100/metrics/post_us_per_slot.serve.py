"""Device time of the head and the decode a person slot in a serve cell's
traced stretch, in us: the program's ``model.head`` spans (deconvs or
upsampling, residual, final layer; both flip passes) and ``serve.post``
(flip average, DARK decode) over ``predictor.slots``."""

from bench_h100.metrics import program_spans


def read(ctx):
    return program_spans.per_slot_us(ctx, "model.head", "serve.post")
