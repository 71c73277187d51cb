"""What the program recorded of a serve cell's traced stretch, for the
readers of the per-layer metrics that read it.

``i2rnet_tpu_torch.tracing`` records while a ``torch.profiler`` session
records, so its ``snapshot()`` after a ``--trace 1`` run holds the spans and
counters of the calls ``trace.CallStretch`` profiled, and nothing of the
window. A program without that module, or one that recorded nothing, gives
every reader None; so does a device metric where the spans carry no device
interval (the CPU).
"""

from __future__ import annotations


def snapshot(ctx):
    """The program's snapshot of the stretch, or None."""
    if ctx.get("kind") != "serve" or "trace" not in ctx:
        return None
    try:
        from i2rnet_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    return snap if snap["spans"] else None


def spans(snap, *names):
    return [s for s in snap["spans"] if s["name"] in names]


def device_seconds(snap, *names):
    """Device seconds of the spans named ``names``; None where there are none
    or one carries no device interval."""
    got = [s["device_ns"] for s in spans(snap, *names)]
    if not got or any(d is None for d in got):
        return None
    return sum(b - a for a, b in got) / 1e9


def per_slot_us(ctx, *names):
    """Device microseconds of the spans named ``names`` over the stretch's
    person slots (``predictor.slots``: B x n of each bucket call)."""
    snap = snapshot(ctx)
    if snap is None:
        return None
    slots = snap["counters"].get("predictor.slots")
    t = device_seconds(snap, *names)
    if not slots or t is None:
        return None
    return t * 1e6 / slots


def bucket_calls(snap):
    """Each bucket call's device interval, ``(first start, last end)`` in ns
    over its device spans (``predictor.h2d`` first, ``predictor.readback``
    last), in time order."""
    calls = {}
    for s in snap["spans"]:
        ids, dev = s["ids"], s["device_ns"]
        if dev is None or "bucket" not in ids:
            continue
        key = (ids.get("call"), ids["bucket"])
        lo, hi = calls.get(key, dev)
        calls[key] = (min(lo, dev[0]), max(hi, dev[1]))
    return sorted(calls.values())
