#!/usr/bin/env python3
"""Checks of the port's recorder (``i2rnet_tpu_torch/tracing.py``) on the
card, from the repository root:

    python3 tracing_probe.py clock --workload <cell> --seed <n>
    python3 tracing_probe.py cost --workload <cell> --seed <n>
    python3 tracing_probe.py race

``clock`` runs a benchmark cell once with ``--trace 1`` in this process
(``bench_h100.run.run_cell``), keeps the profiler events that the
benchmark's ``trace.reduce`` is given for the traced stretch, prints the
result line, then one JSON line that holds the recorder against the
profiler: for each device span, the offset of its start and end events from
the first and last kernel launched inside its ``i2rnet/<name>`` range, and
of its host end stamp from that range's end (two host clocks that slide
apart move both), also by bucket call for the model's spans; the gaps
between bucket calls (what ``call_gap_ms.serve`` reads) against the
profiler's idle seconds, with the idle inside calls and at the stretch's
edges; those gaps split by the innermost program span open on the host;
and the width of the anchors' host brackets.

``cost`` runs the cell untraced with ``tracing.enable()`` over the whole
process and prints the result line: against untraced runs of
``python3 -m bench_h100.run``, the cost of recording.

``race`` times device spans on one thread while another takes snapshots
for five seconds, prints one JSON line and exits 1 if a snapshot raised or
a finished span stayed unresolved.

Each needs a CUDA card: without one it prints nothing and exits 2, as
``bench_h100.run`` does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent
#: spans that hold a whole call or a request's wait, never the host work in a gap
OUTER = ("predictor.predict", "predictor.bucket_call", "batcher.queue_wait")
#: spans that begin before the stretch's profiler starts
BEFORE = ("batcher.queue_wait", "batcher.handover")


def run_traced(spec, workload: str, seed: int, seconds: float, device: str):
    """The result line of one traced run, the profiler's events of its
    stretch and the benchmark's reduction of them (``trace.reduce``, wrapped
    for the run to keep its arguments)."""
    from bench_h100 import trace
    from bench_h100.run import run_cell

    kept = {}
    reduce = trace.reduce

    def keeping(events, window_s, *args, **kwargs):
        kept.update(events=events, reduced=reduce(events, window_s, *args, **kwargs))
        return kept["reduced"]

    trace.reduce = keeping
    try:
        line = run_cell(spec, workload, seed, seconds, True, device, T_START)
    finally:
        trace.reduce = reduce
    return line, kept["events"], kept["reduced"]


def clock_check(snap, events, reduced) -> dict:
    """The recorder's spans against the profiler's ``events``; ``reduced``:
    the benchmark's ``trace.reduce`` of them (busy and window seconds)."""
    from torch.autograd import DeviceType

    from bench_h100.metrics.program_spans import bucket_calls
    from i2rnet_tpu_torch.tracing import PREFIX

    # device events by launch (correlation id), as trace.reduce filters them;
    # the runtime calls that launched them; the program's ranges
    dev, launches, ranges = {}, [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or e.name().startswith("ProfilerStep#")):
                dev.setdefault(e.correlation_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith(PREFIX):
            ranges.setdefault(e.name()[len(PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches.append((e.start_ns(), e.start_thread_id(), e.correlation_id()))
    launches.sort()
    times = [t for t, _, _ in launches]

    offsets, by_call = {}, {}
    for s in snap["spans"]:
        if s["device_ns"] is None or s["name"] not in ranges:
            continue
        a, b, tid = min(ranges[s["name"]], key=lambda r: abs(r[0] - s["start_ns"]))
        if abs(a - s["start_ns"]) > 1_000_000:
            continue
        lo, hi = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        kernels = [iv for _, t, c in launches[lo:hi] if t == tid for iv in dev.get(c, [])]
        if not kernels:
            continue
        row = {"start_us": (s["device_ns"][0] - min(k[0] for k in kernels)) / 1e3,
               "end_us": (s["device_ns"][1] - max(k[1] for k in kernels)) / 1e3,
               "host_end_us": (s["end_ns"] - b) / 1e3}
        o = offsets.setdefault(s["name"], {k: [] for k in row})
        for k, v in row.items():
            o[k].append(v)
        if s["name"].startswith("model."):
            c = by_call.setdefault(f'{s["ids"].get("call")}.{s["ids"].get("bucket")}',
                                   {"device_start_us": [], "host_end_us": []})
            c["device_start_us"].append(row["start_us"])
            c["host_end_us"].append(row["host_end_us"])
    by_name = {name: {"n": len(o["start_us"]),
                      **{f"{k}_median": statistics.median(v) for k, v in o.items()},
                      **{f"{k}_widest": max(v, key=abs) for k, v in o.items()}}
               for name, o in offsets.items()}

    intervals = [iv for ivs in dev.values() for iv in ivs]
    calls = bucket_calls(snap)
    pairs = [(x[1], y[0]) for x, y in zip(calls, calls[1:])]
    # the stretch's edges: from its first span to the first bucket call's
    # device start, and from the last one's device end to its last span
    recorded = [s for s in snap["spans"] if s["name"] not in BEFORE]
    edges = ((calls[0][0] - min(s["start_ns"] for s in recorded)) / 1e9,
             (max(s["end_ns"] for s in recorded) - calls[-1][1]) / 1e9) if calls else None
    anchors = [(s["end_ns"] - s["start_ns"]) / 1e3 for s in snap["spans"]
               if s["name"] == "tracing.anchor"]
    return {"offsets": by_name,
            "model_by_bucket_call": {k: {n: [min(v), max(v)] for n, v in c.items()}
                                     for k, c in by_call.items()},
            "model_device_us_widest": max((abs(v) for name, o in offsets.items()
                                           if name.startswith("model.") for v in
                                           o["start_us"] + o["end_us"]), default=None),
            "bucket_calls": len(calls), "pairs": len(pairs),
            "gap_s_sum": sum(b - a for a, b in pairs) / 1e9,
            "idle_s": reduced["window_s"] - reduced["busy_s"],
            "window_s": reduced["window_s"], "busy_s": reduced["busy_s"],
            "idle_in_calls_s": sum(_idle_within(intervals, a, b) for a, b in calls),
            "lead_in_tail_s": edges, "gap_split_s": _split(snap, pairs),
            "anchor_us_min_max": [min(anchors), max(anchors)] if anchors else None}


def _idle_within(intervals, a: int, b: int) -> float:
    """Seconds of [a, b] that no device interval covers."""
    from bench_h100.trace import union_seconds

    inside = [(max(x, a), min(y, b)) for x, y in intervals if y > a and x < b]
    return (b - a) / 1e9 - union_seconds(inside)


def _split(snap, pairs) -> dict:
    """Seconds of the gaps under the innermost program span open on the
    host (the spans of the thread that made the calls), by name."""
    threads = {s["thread"] for s in snap["spans"] if s["name"] == "predictor.bucket_call"}
    host = [s for s in snap["spans"] if s["thread"] in threads]
    out = {}
    for a, b in pairs:
        cover = [s for s in host if s["start_ns"] < b and s["end_ns"] > a]
        cuts = sorted({a, b} | {t for s in cover for t in (s["start_ns"], s["end_ns"])
                                if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            open_ = [s for s in cover if s["start_ns"] <= x and s["end_ns"] >= y]
            inner = [s for s in open_ if s["name"] not in OUTER]
            name = max(inner, key=lambda s: s["start_ns"])["name"] if inner else (
                "(a call, between spans)" if open_ else "(no span)")
            out[name] = out.get(name, 0.0) + (y - x) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def race(device: str, seconds: float = 5.0) -> dict:
    """Device spans on a worker thread while this one takes snapshots."""
    import torch

    from i2rnet_tpu_torch import tracing

    tracing.reset()
    tracing.enable()
    x = torch.randn(2048, 2048, device=device) / 64
    stop, errors = threading.Event(), []

    def work():
        try:
            y = x
            while not stop.is_set():
                with tracing.span("race.work", device=y):
                    for _ in range(8):
                        y = torch.tanh(y @ x)
        except Exception as e:  # noqa: BLE001 (reported)
            errors.append(f"worker: {e!r}")

    worker = threading.Thread(target=work)
    worker.start()
    snapshots, t_end = 0, time.perf_counter() + seconds
    try:
        while time.perf_counter() < t_end and worker.is_alive():
            tracing.snapshot()
            snapshots += 1
    except Exception as e:  # noqa: BLE001 (reported)
        errors.append(f"snapshot: {e!r}")
    finally:
        stop.set()
        worker.join()
    spans = [s for s in tracing.snapshot()["spans"] if s["name"] == "race.work"]
    tracing.disable()
    unresolved = sum(s["device_ns"] is None for s in spans)
    return {"race": {"snapshots": snapshots, "spans": len(spans), "unresolved": unresolved,
                     "errors": errors},
            "ok": bool(spans) and not errors and unresolved == 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("clock", "cost", "race"))
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    if args.mode != "race" and (args.workload is None or args.seed is None):
        p.error(f"{args.mode} needs --workload and --seed")

    import torch

    if not torch.cuda.is_available():
        print("tracing_probe: needs a CUDA card; found none", file=sys.stderr)
        return 2
    from bench_h100.run import _plain, run_cell
    from bench_h100.spec import Spec
    from i2rnet_tpu_torch import tracing

    device = "cuda:0"
    card = torch.cuda.get_device_name(0)
    if args.mode == "race":
        out = race(device)
        print(json.dumps({**out, "device": card}), flush=True)
        return 0 if out["ok"] else 1
    spec = Spec(REPO)
    if args.mode == "cost":
        tracing.enable()
        line = run_cell(spec, args.workload, args.seed, args.seconds, False, device, T_START)
        line["printed"]["recorded_spans"] = len(tracing.snapshot()["spans"])
        print(json.dumps(line, default=_plain), flush=True)
        return 0
    line, events, reduced = run_traced(spec, args.workload, args.seed, args.seconds, device)
    print(json.dumps(line, default=_plain), flush=True)
    check = clock_check(tracing.snapshot(), events, reduced)
    print(json.dumps({"clock_check": check, "workload": args.workload, "seed": args.seed,
                      "device": card}, default=_plain), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
