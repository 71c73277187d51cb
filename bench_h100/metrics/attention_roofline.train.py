"""The encoder attention's share of its roofline in the traced stretch of
a train cell, in %: the least time its work on the valid persons needs
(``flops.attention_bound``) over the device time of the kernels launched
inside ``models/encoder.py::SelfAttention`` (its spans)."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or not t or not t["span_s"].get("attention"):
        return None
    return 100.0 * t["attention_bound_s"] / t["span_s"]["attention"]
