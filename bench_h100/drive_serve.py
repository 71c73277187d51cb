"""A serving cell: single-image requests in a closed loop into the port's
``serving.MicroBatcher`` over an in-process ``serving.Predictor``.

Set-up builds the configuration's model, loads the seeded weights, warms
each person bucket with ``Predictor.warmup`` and sends one full call of
real requests through the batcher that serves the window (a thread's first
call pays its own cuDNN and cuBLAS set-up). ``setup_s`` leaves out the
seconds of the reference's calibration of the weights, which is the
benchmark's work, not the program's. The window keeps ``in_flight``
requests outstanding: each completion, until the window's end, submits the
next request of the pool. At the end no more are sent, and the window closes
when the last one returns, so it holds whole calls. Rate and tail are over
every request of the window. With ``--trace 1`` the same loop goes on
through the same batcher for a traced stretch of whole calls, profiled on
the batcher's own thread (``trace.CallStretch``), with spans around
packing, the device call and each encoder attention.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from bench_h100 import check, flops, trace, traffic
from bench_h100.common import TRACE_SECONDS, free, now, peak_bytes, seeded_weights, sync
from bench_h100.reference.nets import Net, exact_f32
from bench_h100.reference.serve import answer


class ClosedLoop:
    """``in_flight`` requests outstanding against ``batcher`` until ``t_end``,
    the pool's requests taken in turn from ``start``."""

    def __init__(self, batcher, requests, in_flight: int, start: int = 0):
        self.batcher, self.requests, self.in_flight = batcher, requests, in_flight
        self.lock = threading.Lock()
        self.records = {}
        self.next = start
        self.outstanding = 0
        self.done = threading.Event()

    def _submit(self):
        with self.lock:
            i = self.next
            self.next += 1
            self.outstanding += 1
        img, boxes = self.requests[i % len(self.requests)]
        self.records[i] = [now(), None, None]
        self.batcher.submit(img, boxes).add_done_callback(lambda f, i=i: self._finish(i, f))

    def _finish(self, i, fut):
        t = now()
        self.records[i][1] = t
        self.records[i][2] = fut.exception() or fut.result()
        with self.lock:
            self.outstanding -= 1
            last = self.outstanding == 0
        if t < self.t_end:
            self._submit()
        elif last:
            self.done.set()

    def stop(self):
        """Send no more requests; the loop ends when the outstanding ones return."""
        self.t_end = -math.inf

    def run(self, seconds: float):
        self.t0 = now()
        self.t_end = self.t0 + seconds
        for _ in range(self.in_flight):
            self._submit()
        if not self.done.wait(timeout=seconds + 300):
            raise RuntimeError("requests still outstanding 300 s after the window")
        return self.t0, max(r[1] for r in self.records.values())


def rows_of(n_boxes: int, n_max: int):
    return [min(n_max, n_boxes - j) for j in range(0, n_boxes, n_max)]


def run(job):
    t_run = now()
    from i2rnet_tpu_torch.models.encoder import SelfAttention
    from i2rnet_tpu_torch.models.interformer import build_model
    from i2rnet_tpu_torch.serving import MicroBatcher, Predictor

    cfg, mix, cell, dev = job["cfg"], job["mix"], job["cell"], job["device"]
    pairs = cfg["FLIP_PAIRS"]
    n_max = cell["buckets"][-1]
    passes = 2 if cfg["TEST"]["FLIP_TEST"] else 1
    phases = {**job.get("marks", {}), "to_run_s": t_run - job["t_start"]}
    t = now()
    requests = traffic.serve_requests(mix, job["seed"])
    phases["traffic_s"] = now() - t
    t = now()
    model = build_model(cfg, device=dev)
    params, shapes, calibration_s = seeded_weights(model, cfg, job["seed"], dev, calibrated=True)
    phases["weights_s"] = now() - t - calibration_s
    phases["calibration_s"] = calibration_s
    pred = Predictor(model, cfg, pairs, batch_images=cell["batch_images"],
                     n_buckets=cell["buckets"], raw_hw=mix["canvas_hw"])
    calls, rows = [], []
    stretch = trace.CallStretch(TRACE_SECONDS)
    stretch_persons = [0]
    predict, pack, call = pred.predict, pred.pack, pred._call

    def counted(images, boxes):
        traced = stretch.enter()
        t = now()
        try:
            if not traced:
                return predict(images, boxes)
            with trace.span("predict"):
                return predict(images, boxes)
        finally:
            calls.append((len(images), now() - t))
            if traced:
                stretch_persons[0] += sum(len(b) for b in boxes)

    def packed(n, chunk):
        if not stretch.active:
            return pack(n, chunk)
        rows.append([len(c[3]) for c in chunk])
        with trace.span("pack"):
            return pack(n, chunk)

    def called(args):
        if not stretch.active:
            return call(args)
        with trace.span("device_call"):
            return call(args)

    pred.predict, pred.pack, pred._call = counted, packed, called
    t = now()
    pred.warmup()
    phases["warmup_s"] = now() - t
    t = now()
    batcher = MicroBatcher(pred, mix["max_delay_ms"])
    first = [batcher.submit(*requests[i % len(requests)]) for i in range(pred.batch_images)]
    for fut in first:
        fut.result()
    sync(dev)
    phases["first_call_s"] = now() - t
    calls.clear()
    setup_s = now() - job["t_start"] - calibration_s

    loop = ClosedLoop(batcher, requests, mix["in_flight"])
    try:
        t0, t_done = loop.run(job["seconds"])
        window_calls = list(calls)
        if job["trace"]:
            tail = ClosedLoop(batcher, requests, mix["in_flight"], start=loop.next)
            stretch.on_stop = tail.stop
            hooks = trace.hook_module_spans(
                [m for m in model.modules() if isinstance(m, SelfAttention)], "attention")
            stretch.armed = True
            try:
                tail.run(600.0)
            finally:
                for h in hooks:
                    h.remove()
            if not stretch.done.is_set():
                raise RuntimeError("the traced stretch did not end")
    finally:
        batcher.close()
    window_s = t_done - t0
    recs = loop.records
    failed = [i for i, r in recs.items() if isinstance(r[2], BaseException)]
    sizes = {i: len(requests[i % len(requests)][1]) for i in recs}
    persons = sum(sizes[i] for i in recs if i not in failed)
    lat_ms = np.array([(r[1] - r[0]) * 1e3 for r in recs.values()])
    row = {m: passes * flops.row_flops(cfg, shapes, m) for m in range(1, n_max + 1)}
    model_flops = sum(row[m] for i in recs if i not in failed for m in rows_of(sizes[i], n_max))
    ctx = {"kind": "serve", "window_s": window_s, "persons": persons, "flops": model_flops,
           "calls": len(window_calls), "images": sum(c[0] for c in window_calls)}
    call_s = [c[1] for c in window_calls]
    out = {"serve_persons_s": persons / window_s,
           "serve_p95_ms": float(np.percentile(lat_ms, 95)), "setup_s": setup_s}

    if job["trace"]:
        red = trace.reduce(stretch.result["events"], stretch.result["window_s"])
        red["traced_persons"] = stretch_persons[0]
        red["traced_calls"] = stretch.calls
        red["attention_bound_s"] = flops.attention_bound(cfg, rows, passes)
        ctx["trace"] = red
    memory = peak_bytes(dev)

    pred.predict, pred.pack, pred._call = predict, pack, call
    del pred, model, batcher
    free(dev)
    rng = np.random.default_rng(job["seed"] + 7)
    done = sorted(i for i in recs if i not in failed)
    k = min(cell["check_requests"], len(done))
    pick = set(rng.choice(done, size=k, replace=False).tolist())
    pick.add(max(done, key=lambda i: (sizes[i], -i)))
    pick = sorted(pick)
    net = Net(params, cfg)
    answers = []
    with torch.no_grad(), exact_f32():
        for i in pick:
            img, boxes = requests[i % len(requests)]
            answers.append(answer(net, cfg, pairs, torch.as_tensor(img, device=dev), boxes,
                                  n_max))
    numbers = check.serve_numbers([recs[i][2] for i in pick], answers, cell["peak_margin"])
    correct, compared = check.verdict(numbers, cell["limits"])
    printed = {"conf_gap": numbers["conf_gap"], "conf_rms": numbers["conf_rms"],
               "pos_gap_px": numbers["pos_gap_px"], "held_share": numbers["held_share"],
               "checked_requests": len(pick), "pos_by_margin": numbers["by_margin"],
               "window_s": window_s,
               "latency_ms_p50_max": [float(np.median(lat_ms)), float(lat_ms.max())],
               "call_s_min_p50_max": [min(call_s), float(np.median(call_s)), max(call_s)],
               "setup_phases_s": phases}
    if job["trace"]:
        printed["traced_calls"] = stretch.calls
    return {"values": out, "ctx": ctx, "correct": correct and not failed,
            "attempted": len(recs), "failed": len(failed), "memory": memory,
            "compared": compared, "printed": printed}
