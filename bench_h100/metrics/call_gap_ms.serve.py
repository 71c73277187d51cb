"""Device idle between bucket calls in a serve cell's traced stretch, in
ms: the mean, over the stretch's consecutive pairs of bucket calls, of the
time from one call's last device span (its ``predictor.readback``) to the
next one's first (its ``predictor.h2d``), on the program's device clock."""

from bench_h100.metrics import program_spans


def read(ctx):
    snap = program_spans.snapshot(ctx)
    if snap is None:
        return None
    calls = program_spans.bucket_calls(snap)
    gaps = [b[0] - a[1] for a, b in zip(calls, calls[1:])]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
