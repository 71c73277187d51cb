"""The port's recorder: spans and counters of what each layer does, waits
for and wastes, on the clock of ``torch.profiler``'s trace.

    from i2rnet_tpu_torch import tracing
    with tracing.span("predictor.pack", bucket=1):       # a host span
        ...
    with tracing.span("model.trunk", device=x):           # and x's device time
        ...
    tracing.count("predictor.slots", b * n)

It records while :func:`enable` is in effect or while a ``torch.profiler``
session records (checked as each span opens); otherwise :func:`span` is one
branch that returns a shared null context: no record, no
``record_function``, no CUDA event. :func:`snapshot` returns what was
recorded as plain Python data; :func:`reset` clears it.

* A span keeps its name, start and end (``time.time_ns()``, the Unix-epoch
  nanoseconds kineto reports its host events in), its parent (the span open
  on the same thread when it opened), the thread (its native id) and its ids:
  those given, merged over its parent's, so every span under one
  ``Predictor.predict`` carries that call's ``call`` id. While a profiler
  records, a span also opens ``record_function("i2rnet/<name>")``, which puts
  it in the profiler's trace beside the kernels it launched; its host stamps
  enclose that range.
* A span opened with ``device=`` a CUDA tensor or device also records a
  pair of timing events on the current stream, mapped to the host's clock
  through anchor events (the device synchronised, then of
  :data:`ANCHOR_TRIES` events recorded and waited for, the one whose host
  stamps before its record and after its wait lie closest, at their
  midpoint; recorded as a ``tracing.anchor`` span): ``Predictor.predict`` takes a new
  anchor as each call starts, the device idle; a device without one gets it
  at its first device span; the first call after recording stops takes one
  too. At the next anchor (or in :func:`snapshot`, which takes one) the
  finished events since the last are resolved into
  ``device_ns``, the device clock's rate against the host's taken from the
  two anchors; a span that another thread closes after the anchor's
  synchronise waits for a later one.
* Counters: :func:`count` adds to a total that always counts (the kernel
  launch counts of ``ops.cuda.launch_counts`` read it, :func:`total`) and,
  while recording, to the counter :func:`snapshot` reports.
* Spans are kept in a buffer of :data:`CAPACITY`; past it the oldest go,
  counted as ``tracing.dropped``.

Inside a program ``torch.export`` or ``torch.compile`` traces, spans record
nothing: the exported serving artifact keeps only the ``Predictor`` and
``MicroBatcher`` spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: the prefix of the spans' ranges in a profiler's trace
PREFIX = "i2rnet/"
#: spans kept before the oldest are dropped
CAPACITY = 1 << 16
#: unresolved device spans kept before the finished ones are resolved
PENDING_RESOLVE = 4096
#: events an anchor records to find the one the host clock brackets closest
ANCHOR_TRIES = 3


#: the shared context of a span that records nothing
_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of a tensor, device or name; None off CUDA."""
    if device is None:
        return None
    dev = device.device if isinstance(device, torch.Tensor) else torch.device(device)
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


class _Span:
    """An open span; its record joins the recorder's buffer when it closes."""

    __slots__ = ("rec", "name", "device", "ids", "record", "rf", "events")

    def __init__(self, rec: "Recorder", name: str, device, ids: Dict):
        self.rec, self.name, self.device, self.ids = rec, name, device, ids

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        parent = stack[-1].record if stack else None
        self.record = {"id": next(rec._ids), "name": self.name, "start_ns": time.time_ns(),
                       "end_ns": None, "thread": threading.get_native_id(),
                       "parent": parent["id"] if parent else None,
                       "ids": {**parent["ids"], **self.ids} if parent else dict(self.ids),
                       "device_ns": None}
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.events = rec._start_events(self.device)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            _, stream, _, end, _ = self.events
            end.record(stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.record["end_ns"] = time.time_ns()
        self.rec._stack().pop()
        self.rec._keep(self.record, self.events)
        return False


class Recorder:
    """Spans and counters of one process (the module's functions act on
    :data:`RECORDER`)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: collections.deque = collections.deque()
        self._counters: Dict[str, int] = {}
        self._totals: Dict[str, int] = {}
        self._pending: list = []
        self._anchors: Dict[int, tuple] = {}
        self._ids = itertools.count(1)
        self._calls = itertools.count(1)
        self._requests = itertools.count(1)

    def recording(self) -> bool:
        return self.enabled or _profiling()

    def span(self, name: str, device=None, **ids):
        """A context that records a span ``name`` with ``ids`` (and, with
        ``device`` a CUDA tensor or device, its device interval)."""
        if not (self.enabled or _profiling()):
            return _NULL
        if torch.compiler.is_compiling() or torch.compiler.is_exporting():
            return _NULL
        return _Span(self, name, device, ids)

    def record(self, name: str, start_ns: int, end_ns: int, **ids) -> None:
        """A finished span from stamps taken elsewhere (a request's queue
        wait, from its ``submit``); no parent."""
        if self.recording():
            self._keep({"id": next(self._ids), "name": name, "start_ns": int(start_ns),
                        "end_ns": int(end_ns), "thread": threading.get_native_id(),
                        "parent": None, "ids": ids, "device_ns": None}, None)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + n
            if self.enabled or _profiling():
                self._counters[name] = self._counters.get(name, 0) + n

    def total(self, name: str) -> int:
        """What ``name`` counted since the last reset, recording or not."""
        return self._totals.get(name, 0)

    def clear(self, prefix: str) -> None:
        """Zero every counter and total whose name starts with ``prefix``."""
        with self._lock:
            for d in (self._counters, self._totals):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]

    def request(self):
        """``(request id, submit time in ns)`` of a request as it arrives."""
        return next(self._requests), time.time_ns()

    def begin_call(self, device=None) -> int:
        """A new call id for this thread's next call, its start stamped
        (:meth:`last_call`); while recording, or while device spans wait to
        be resolved, a new anchor on ``device``."""
        call = next(self._calls)
        self._local.call = (call, time.time_ns())
        if self.recording() or self._pending:
            self.anchor(device)
        return call

    def last_call(self):
        """``(call id, start ns)`` of the call this thread began last."""
        return getattr(self._local, "call", (None, None))

    def anchor(self, device=None):
        """Synchronise ``device`` and record the event its later device spans
        are timed from, with its host time; resolves the device spans since
        the last anchor. None off CUDA."""
        dev = _cuda_index(device)
        if dev is None:
            return None
        torch.cuda.synchronize(dev)
        stream = torch.cuda.current_stream(dev)
        best = None
        for _ in range(ANCHOR_TRIES):
            ev = torch.cuda.Event(enable_timing=True)
            before = time.time_ns()
            ev.record(stream)
            ev.synchronize()
            after = time.time_ns()
            if best is None or after - before < best[1] - best[0]:
                best = (before, after, ev)
        before, after, ev = best
        self.record("tracing.anchor", before, after, device=dev)
        new = ((before + after) // 2, ev)
        self._resolve(dev, new)
        self._anchors[dev] = new
        return new

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def snapshot(self) -> Dict:
        """``{"spans": [...], "counters": {...}}``: every kept span (``id``,
        ``name``, ``start_ns``, ``end_ns``, ``thread``, ``parent``, ``ids``,
        ``device_ns`` [start, end] or None) and the counters counted while
        recording. Takes a new anchor on each device with spans to resolve
        (it synchronises the device) and resolves those done by then; a
        device span still in flight on another thread reads ``device_ns``
        None until a later snapshot."""
        with self._lock:
            devices = {events[0] for _, events in self._pending}
        for dev in devices:
            self.anchor(dev)
        with self._lock:
            spans = [dict(r, ids=dict(r["ids"]),
                          device_ns=list(r["device_ns"]) if r["device_ns"] else None)
                     for r in self._spans]
            return {"spans": spans, "counters": dict(self._counters)}

    def reset(self) -> None:
        """Forget every span, counter, total and anchor."""
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._totals.clear()
            self._pending.clear()
            self._anchors.clear()

    # internals

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _start_events(self, device):
        dev = _cuda_index(device)
        if dev is None:
            return None
        anchor = self._anchors.get(dev) or self.anchor(dev)
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return dev, stream, start, end, anchor

    def _keep(self, record: Dict, events) -> None:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                self._counters["tracing.dropped"] = self._counters.get("tracing.dropped", 0) + 1
                self._totals["tracing.dropped"] = self._totals.get("tracing.dropped", 0) + 1
            self._spans.append(record)
            if events is not None:
                self._pending.append((record, events))
                crowded = len(self._pending) > PENDING_RESOLVE
            else:
                crowded = False
        if crowded:
            self._resolve()

    def _resolve(self, dev: Optional[int] = None, closing=None) -> None:
        """Device spans' events into ``device_ns``, of those already done:
        those of device ``dev``, the device's clock rate taken from their
        anchor to the ``closing`` anchor (host ns, event); without one, those
        of any device, at the device clock's rate. A span another thread
        closed after the anchor's synchronise waits for a later resolve."""
        with self._lock:
            pending, self._pending = self._pending, []
        left, rates = [], {}
        for entry in pending:
            record, (d, _, start, end, (t0, anchor)) = entry
            if (dev is not None and d != dev) or not end.query():
                left.append(entry)
                continue
            rate = 1.0
            if closing is not None:
                if id(anchor) not in rates:
                    span_ns = anchor.elapsed_time(closing[1]) * 1e6
                    rates[id(anchor)] = (closing[0] - t0) / span_ns if span_ns > 0 else 1.0
                rate = rates[id(anchor)]
            record["device_ns"] = [t0 + round(anchor.elapsed_time(start) * 1e6 * rate),
                                   t0 + round(anchor.elapsed_time(end) * 1e6 * rate)]
        if left:
            with self._lock:
                self._pending[:0] = left


#: the process's recorder
RECORDER = Recorder()

span = RECORDER.span
record = RECORDER.record
count = RECORDER.count
total = RECORDER.total
clear = RECORDER.clear
request = RECORDER.request
begin_call = RECORDER.begin_call
last_call = RECORDER.last_call
anchor = RECORDER.anchor
enable = RECORDER.enable
disable = RECORDER.disable
snapshot = RECORDER.snapshot
reset = RECORDER.reset
recording = RECORDER.recording
