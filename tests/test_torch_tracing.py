"""The port's recorder (``i2rnet_tpu_torch/tracing.py``) on the tiny W48
model served through ``Predictor`` and ``MicroBatcher`` on the CPU.

* Off (no ``enable()``, no profiler): nothing is recorded, no
  ``record_function`` and no CUDA event is made, and the outputs are the bits
  a recorded run gives.
* Under a CPU ``torch.profiler``: the spans, their parents and their
  ``call``, ``bucket`` and ``request`` ids, each span's stamps within 1 ms of
  its ``i2rnet/<name>`` range in the kineto events (the same Unix-epoch
  clock), and no device interval (there is no card).
* The counters against what the requests imply; the kernel launch counts
  read through them; the buffer's bound and its drop counter; counts from
  many threads.
* The benchmark's readers of the recorded spans, loaded through
  ``bench_h100.spec.Spec.reader``: their values over a tiny run, None for the
  device readers here and outside a traced serve run.
* ``export_predictor`` with recording on: the exported graph holds no
  profiler op, the spans being traced away.
"""

import io
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tracing_probe
from bench_h100.spec import Spec
from i2rnet_tpu_torch import presets, tracing
from i2rnet_tpu_torch.ops.cuda import KERNELS, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.library import graph_ops
from i2rnet_tpu_torch.serving import MicroBatcher, Predictor, export_predictor
from test_torch_bridge import port_model, random_variables, tiny_jax_model

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
B, BUCKETS, RAW_HW = 2, (2, 3), (96, 128)
FLIP_PAIRS = [[1, 2], [3, 4]]  # COCO's pairs within K=5
#: the readers of the recorded spans, and whether they need device intervals
READERS = {"queue_wait_p95_ms.serve": False, "slot_fill.serve": False,
           "host_pack_ms.serve": False, "h2d_gb_s.serve": True, "call_gap_ms.serve": True,
           "preprocess_us_per_slot.serve": True, "trunk_us_per_slot.serve": True,
           "intra_us_per_slot.serve": True, "inter_us_per_slot.serve": True,
           "post_us_per_slot.serve": True}
#: a bucket call's spans under ``predictor.bucket_call``, with their parents
BUCKET_SPANS = {"predictor.pack": "predictor.bucket_call", "predictor.h2d": "predictor.pack",
                "serve.preprocess": "predictor.bucket_call",
                "model.trunk": "predictor.bucket_call", "model.inter": "predictor.bucket_call",
                "model.head": "predictor.bucket_call", "serve.post": "predictor.bucket_call",
                "predictor.readback": "predictor.bucket_call"}


@pytest.fixture(scope="module")
def served():
    jcfg, jmodel = tiny_jax_model(use_pallas=False)
    cfg = presets.from_config(jcfg)
    model = port_model(random_variables(jmodel, jcfg, seed=3), jcfg)
    return cfg, model, Predictor(model, cfg, FLIP_PAIRS, batch_images=B, n_buckets=BUCKETS,
                                 raw_hw=RAW_HW)


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts from an empty recorder, off, and leaves it so."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def requests(counts, seed=0):
    """Images with ``counts[i]`` boxes each (0: the whole image)."""
    rng = np.random.RandomState(seed)
    images = [rng.randint(0, 256, (64 + 8 * (i % 3), 96, 3)).astype(np.uint8)
              for i in range(len(counts))]
    boxes = [[[3.0 + 5 * j, 2.0 + 3 * j, 30.0, 44.0] for j in range(m)] for m in counts]
    return images, boxes


def batched(pred, images, boxes, delay_ms):
    """Every request submitted at once to a new batcher; its results."""
    mb = MicroBatcher(pred, max_delay_ms=delay_ms)
    try:
        futs = [mb.submit(img, bxs) for img, bxs in zip(images, boxes)]
        return [f.result(timeout=120) for f in futs]
    finally:
        mb.close()


def implied(counts):
    """What ``Predictor`` at B, BUCKETS does with images of ``counts`` boxes:
    its bucket calls as (n, rows) and the valid persons."""
    rows = {n: 0 for n in BUCKETS}
    persons = 0
    for m in counts:
        m = m or 1
        persons += m
        for j in range(0, m, BUCKETS[-1]):
            rows[next(n for n in BUCKETS if min(BUCKETS[-1], m - j) <= n)] += 1
    calls = [(n, min(B, r - j)) for n, r in rows.items() for j in range(0, r, B)]
    return calls, persons


def h2d_bytes(n):
    """The seven arrays of one (B, n) call: canvas, two affines, rects,
    valid, centers, scales."""
    return B * (RAW_HW[0] * RAW_HW[1] * 3 + n * (2 * 24 + 16 + 1 + 8 + 8))


class Made:
    """Counts what is made through ``torch.profiler.record_function`` and
    ``torch.cuda.Event`` while installed."""

    def __init__(self, monkeypatch):
        self.functions, self.events = 0, 0
        real_rf, real_ev = torch.profiler.record_function, torch.cuda.Event

        def rf(*a, **k):
            self.functions += 1
            return real_rf(*a, **k)

        def ev(*a, **k):
            self.events += 1
            return real_ev(*a, **k)

        monkeypatch.setattr(torch.profiler, "record_function", rf)
        monkeypatch.setattr(torch.cuda, "Event", ev)


def test_off_records_nothing_and_on_gives_the_same_bits(served, monkeypatch):
    _, _, pred = served
    images, boxes = requests([1, 4, 0, 2])
    made = Made(monkeypatch)
    off = pred.predict(images, boxes)
    off_batched = batched(pred, images, boxes, 200.0)
    assert tracing.snapshot() == {"spans": [], "counters": {}}
    assert (made.functions, made.events) == (0, 0)
    tracing.enable()
    on = pred.predict(images, boxes)
    on_batched = batched(pred, images, boxes, 200.0)
    snap = tracing.snapshot()
    assert snap["spans"] and snap["counters"]
    assert made.events == 0  # no card: no device span
    assert made.functions == 0  # enable() alone opens no profiler range
    for got, want in zip(on + on_batched, off + off_batched):
        np.testing.assert_array_equal(got, want)


def test_recorder_spans_under_the_profiler(served):
    """Under a CPU profiler: the tree of one ``predict`` (parents, the call
    and bucket ids), the batcher's calls with each request's queue wait, no
    device interval."""
    _, _, pred = served
    counts = [1, 4, 0, 2, 5]
    images, boxes = requests(counts)
    with profile(activities=[ProfilerActivity.CPU]):
        pred.predict(images, boxes)
        batched(pred, images, boxes, 200.0)
    spans = tracing.snapshot()["spans"]
    by_id = {s["id"]: s for s in spans}
    assert all(s["device_ns"] is None for s in spans)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["thread"] == s["thread"]
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
            assert parent["ids"].items() <= s["ids"].items()
    predicts = [s for s in spans if s["name"] == "predictor.predict"]
    calls, _ = implied(counts)
    assert len({p["ids"]["call"] for p in predicts}) == len(predicts) >= 3
    for p in predicts:
        under = [s for s in spans if s["ids"].get("call") == p["ids"]["call"]
                 and s["name"] != "batcher.queue_wait"]
        names = {s["name"] for s in under}
        assert {"predictor.route", "predictor.assemble", "predictor.bucket_call"} <= names
        buckets = [s for s in under if s["name"] == "predictor.bucket_call"]
        assert [s["ids"]["bucket"] for s in buckets] == list(range(len(buckets)))
        for s in under:
            if s["name"] in BUCKET_SPANS:
                assert by_id[s["parent"]]["name"] == BUCKET_SPANS[s["name"]]
                assert s["ids"]["bucket"] in range(len(buckets))
        assert sum(s["name"] == "model.trunk" for s in under) == 2 * len(buckets)  # flip
        assert sum(s["name"] == "serve.post" for s in under) == 2 * len(buckets)
    assert len([s for s in predicts if s["thread"] == threading.get_native_id()]) == 1
    first = [s for s in predicts if s["thread"] == threading.get_native_id()][0]
    assert len([s for s in spans if s["name"] == "predictor.bucket_call"
                and s["ids"]["call"] == first["ids"]["call"]]) == len(calls)
    waits = [s for s in spans if s["name"] == "batcher.queue_wait"]
    assert len({w["ids"]["request"] for w in waits}) == len(waits) == len(counts)
    batcher_calls = {p["ids"]["call"]: p for p in predicts if p is not first}
    for w in waits:
        served_by = batcher_calls[w["ids"]["call"]]
        assert w["start_ns"] <= w["end_ns"] <= served_by["start_ns"]
    gathers = [s for s in spans if s["name"] == "batcher.gather"]
    resolves = [s for s in spans if s["name"] == "batcher.resolve"]
    handovers = [s for s in spans if s["name"] == "batcher.handover"]
    assert len(gathers) == len(resolves) == len(handovers) == len(batcher_calls)
    assert {r["ids"]["call"] for r in resolves} == set(batcher_calls)
    for h in handovers:
        assert h["start_ns"] <= h["end_ns"] <= batcher_calls[h["ids"]["call"]]["start_ns"]


def test_spans_share_the_profilers_clock(served):
    """Each span of the profiling thread lies within 1 ms of its
    ``i2rnet/<name>`` range in the kineto events, start and end."""
    _, _, pred = served
    images, boxes = requests([3, 1, 2])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.predict(images, boxes)
    mine = [s for s in tracing.snapshot()["spans"] if s["thread"] == threading.get_native_id()]
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX)]
    assert len(mine) == len(ranges) > 20
    for name in {s["name"] for s in mine}:
        ours = sorted((s["start_ns"], s["end_ns"]) for s in mine if s["name"] == name)
        theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in ranges
                        if e.name() == tracing.PREFIX + name)
        assert len(ours) == len(theirs), name
        for (a, b), (c, d) in zip(ours, theirs):
            assert abs(a - c) < 1_000_000 and abs(b - d) < 1_000_000, (name, a - c, b - d)


@pytest.mark.parametrize("counts,delay_ms,cut", [
    ([1, 4], 5000.0, 0),          # one full call
    ([2, 0, 5], 300.0, 1),        # a full call, then one request cut short by the deadline
    ([5, 5, 3, 1, 2], 300.0, 1),  # chunks past B rows and past the largest bucket
], ids=["full", "cut_short", "chunked"])
def test_counters_are_what_the_requests_imply(served, counts, delay_ms, cut):
    _, _, pred = served
    images, boxes = requests(counts)
    tracing.enable()
    batched(pred, images, boxes, delay_ms)
    snap = tracing.snapshot()
    c = snap["counters"]
    batches = [counts[i:i + B] for i in range(0, len(counts), B)]
    calls = [call for chunk in batches for call in implied(chunk)[0]]
    assert sum(s["name"] == "predictor.bucket_call" for s in snap["spans"]) == len(calls)
    assert c["predictor.slots"] == sum(B * n for n, _ in calls)
    assert c["predictor.persons"] == implied(counts)[1]
    assert c["predictor.h2d_bytes"] == sum(h2d_bytes(n) for n, _ in calls)
    assert sum(s["name"] == "predictor.predict" for s in snap["spans"]) == len(batches)
    assert sum(s["name"] == "batcher.queue_wait" for s in snap["spans"]) == len(counts)
    assert c.get("batcher.cut_short", 0) == cut


def test_recording_stops_with_disable(served):
    _, _, pred = served
    images, boxes = requests([1])
    tracing.enable()
    pred.predict(images, boxes)
    kept = tracing.snapshot()
    tracing.disable()
    pred.predict(images, boxes)
    assert tracing.snapshot() == kept
    assert tracing.total("predictor.slots") == 2 * B * BUCKETS[0]  # totals count, recording or not


@pytest.fixture(scope="module")
def tiny_run(served):
    """The snapshot of a batcher's calls recorded under a CPU profiler, the
    requests' box counts and the profiler's events."""
    _, _, pred = served
    counts = [1, 4, 0, 2, 5, 3]
    images, boxes = requests(counts, seed=1)
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            batched(pred, images, boxes, 300.0)
        return tracing.snapshot(), counts, prof.profiler.kineto_results.events()
    finally:
        tracing.reset()


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_over_a_tiny_run(tiny_run, metric, monkeypatch):
    snap, counts, _ = tiny_run
    read = Spec(REPO).reader(metric)
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert read({"kind": "serve"}) is None  # untraced
    assert read({"kind": "train", "trace": {}}) is None
    value = read({"kind": "serve", "trace": {}})
    if READERS[metric]:
        assert value is None  # no card, no device interval
        return
    spans = snap["spans"]
    if metric == "queue_wait_p95_ms.serve":
        waits = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans
                 if s["name"] == "batcher.queue_wait"]
        assert len(waits) == len(counts)
        # the hand-overs to predict take no time here, nothing wrapping it
        assert value == pytest.approx(np.percentile(waits, 95), abs=0.5)
    elif metric == "slot_fill.serve":
        c = snap["counters"]
        assert c["predictor.persons"] == implied(counts)[1]
        assert value == pytest.approx(100.0 * c["predictor.persons"] / c["predictor.slots"])
        assert 0 < value <= 100
    else:
        h2d = {s["parent"]: s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] == "predictor.h2d"}
        packs = [s["end_ns"] - s["start_ns"] - h2d[s["id"]] for s in spans
                 if s["name"] == "predictor.pack"]
        assert len(packs) == sum(s["name"] == "predictor.bucket_call" for s in spans)
        assert value == pytest.approx(np.mean(packs) / 1e6) and value > 0


def test_queue_wait_leaves_out_what_wraps_predict(served, monkeypatch):
    """A wrapper that holds each call 0.3 s before the program's ``predict``
    (as a profiler starting inside the benchmark's wrapper does): the
    hand-overs record it, and the reader's waits leave it out."""
    _, _, pred = served
    predict = pred.predict

    def held(images, boxes):
        time.sleep(0.3)
        return predict(images, boxes)

    monkeypatch.setattr(pred, "predict", held)
    images, boxes = requests([1, 2, 1, 3, 2, 1])
    tracing.enable()
    batched(pred, images, boxes, 5000.0)
    snap = tracing.snapshot()
    handovers = [s for s in snap["spans"] if s["name"] == "batcher.handover"]
    assert len(handovers) == 3
    assert all(0.3e9 <= s["end_ns"] - s["start_ns"] < 0.6e9 for s in handovers)
    raw = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in snap["spans"]
           if s["name"] == "batcher.queue_wait"]
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    net = Spec(REPO).reader("queue_wait_p95_ms.serve")({"kind": "serve", "trace": {}})
    assert net < np.percentile(raw, 95) - 250  # the last call's waited through two holds


def test_readers_without_the_program_give_none(monkeypatch):
    """Over a program without ``tracing`` (the parent of this change), every
    reader returns None and raises nothing."""
    monkeypatch.setitem(sys.modules, "i2rnet_tpu_torch.tracing", None)
    spec = Spec(REPO)
    for metric in READERS:
        assert spec.reader(metric)({"kind": "serve", "trace": {}}) is None, metric


def test_buffer_keeps_the_newest_and_counts_the_dropped():
    rec = tracing.Recorder(capacity=3)
    rec.enable()
    for i in range(5):
        with rec.span("s", i=i):
            pass
    snap = rec.snapshot()
    assert [s["ids"]["i"] for s in snap["spans"]] == [2, 3, 4]
    assert snap["counters"]["tracing.dropped"] == 2


class FakeEvent:
    """A CUDA timing event at ``t`` ms on the device's clock, done or not."""

    def __init__(self, t: float, done: bool = True):
        self.t, self.done = t, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other) -> float:
        if not (self.done and other.done):
            raise RuntimeError("CUDA error: device not ready")
        return other.t - self.t


@pytest.mark.parametrize("closing", [True, False], ids=["at_an_anchor", "crowded"])
def test_resolve_leaves_a_span_still_in_flight(closing):
    """A span that another thread closes after an anchor's synchronise (its
    end event not done yet) waits, unresolved, for a later resolve; the
    finished ones resolve on the anchor's clock."""
    rec = tracing.Recorder()
    t0 = 1_000_000_000
    anchor = (t0, FakeEvent(0.0))
    done, late = {"device_ns": None}, {"device_ns": None}
    late_end = FakeEvent(4.0, done=False)
    rec._pending = [(done, (0, None, FakeEvent(1.0), FakeEvent(2.0), anchor)),
                    (late, (0, None, FakeEvent(3.0), late_end, anchor))]
    rec._resolve(*((0, (t0 + 5_000_000, FakeEvent(5.0))) if closing else ()))
    assert done["device_ns"] == [t0 + 1_000_000, t0 + 2_000_000]
    assert late["device_ns"] is None and [e[0] for e in rec._pending] == [late]
    late_end.done = True
    rec._resolve(*((0, (t0 + 10_000_000, FakeEvent(10.0))) if closing else ()))
    assert late["device_ns"] == [t0 + 3_000_000, t0 + 4_000_000] and not rec._pending


@pytest.mark.parametrize("mode", ["clock", "cost", "race"])
def test_probe_needs_a_card(mode, capsys, monkeypatch):
    """Without a card the probe prints nothing and exits 2, as the benchmark
    does: no rate or clock reading comes from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [mode] + ([] if mode == "race" else ["--workload", "tph-coco.serve.coco",
                                                "--seed", "3300000001"])
    assert tracing_probe.main(argv) == 2
    assert capsys.readouterr().out == ""


def test_probe_clock_check_over_a_tiny_run(tiny_run):
    """The probe's check over the tiny run, its device spans given their
    host stamps as device intervals (no card here): the bucket calls, the
    gaps between them and their split by host span add up."""
    snap, _, events = tiny_run
    device = set(BUCKET_SPANS) - {"predictor.pack"}
    snap = {**snap, "spans": [dict(s, device_ns=[s["start_ns"], s["end_ns"]])
                              if s["name"] in device else s for s in snap["spans"]]}
    check = tracing_probe.clock_check(snap, events, {"busy_s": 0.5, "window_s": 2.0})
    n = sum(s["name"] == "predictor.bucket_call" for s in snap["spans"])
    assert check["bucket_calls"] == n and check["pairs"] == n - 1 > 0
    assert check["offsets"] == {} and check["model_device_us_widest"] is None  # no kernel
    assert check["idle_s"] == 1.5 and check["idle_in_calls_s"] > 0
    assert sum(check["gap_split_s"].values()) == pytest.approx(check["gap_s_sum"])
    assert set(check["gap_split_s"]) <= {"batcher.resolve", "batcher.gather", "batcher.handover",
                                         "predictor.route", "predictor.pack",
                                         "predictor.assemble", "(a call, between spans)",
                                         "(no span)"}
    assert all(t >= 0 for t in check["lead_in_tail_s"])


def test_counts_from_many_threads_add_up():
    rec = tracing.Recorder()
    rec.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [rec.count("n") for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert rec.total("n") == rec.snapshot()["counters"]["n"] == 16 * 2000


def test_launch_counts_read_the_kernel_counters():
    """``launch_counts`` reads ``kernel.<name>``; ``reset_launches`` zeroes
    those alone; the wrappers keep no ``launches`` attribute."""
    tracing.count("kernel.masked_mhsa", 3)
    tracing.count("predictor.slots", 4)
    assert launch_counts() == {**dict.fromkeys(KERNELS, 0), "masked_mhsa": 3}
    reset_launches()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert tracing.total("predictor.slots") == 4
    assert not any(hasattr(fn, "launches") for fn in KERNELS.values())


def test_export_with_recording_on_traces_the_spans_away(served):
    cfg, model, _ = served
    cfg = {**cfg, "DATASET": {**cfg["DATASET"], "DATASET": "coco"}}  # its flip pairs
    tracing.enable()
    payload, header = export_predictor(cfg, model, B, BUCKETS[:1], RAW_HW, device="cpu",
                                       use_kernels=True)
    assert header["kernels"] == ["i2r::conv_epilogue", "i2r::encoder_ffn", "i2r::masked_mhsa"]
    ep = torch.export.load(io.BytesIO(payload))
    assert graph_ops(ep.graph) == header["kernels"]
    assert not [n for n in ep.graph.nodes if "profiler" in str(n.target)]
    traced = [s["name"] for s in tracing.snapshot()["spans"]]
    assert not [name for name in traced if name.startswith(("model.", "serve."))]
