"""Idle share of the card in the traced stretch of a serve cell, in %: one
minus the union of the profiler's device events over the stretch's host
clock."""


def read(ctx):
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
