"""The traced window: ``torch.profiler`` over a stretch of the cell's own
loop, reduced to device busy time, launches, the time of the kernels
launched inside named host ranges, the top device operations and the
longest idle gaps by what the host was doing.

Busy time is the union of the device events' intervals (user annotations
and profiler step markers left out), as ``chip_smoke.py::busy_ms`` takes it.
A kernel belongs to a host range (``span``) where the runtime call that
launched it ran inside the range on the same thread; ranges are opened
around calls by the benchmark's own wrappers and forward hooks, so the
attribution survives a change of kernel.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Dict, List

import torch

SPAN_PREFIX = "bench::"
#: the idle gaps, longest first, that are named by the host's work
GAPS_LABELLED = 400


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    total, cur_s, cur_e = 0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def span(name: str):
    """A host range the trace attributes kernels to (``bench::<name>``)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def hook_module_spans(modules, name: str, backward: bool = False):
    """Forward (and with ``backward`` full backward) hooks that open a span
    ``name`` around each call of each of ``modules``; returns the handles."""
    handles = []
    for mod in modules:
        state = {}

        def pre(m, args, _s=state):
            _s["fwd"] = span(name)
            _s["fwd"].__enter__()

        def post(m, args, out, _s=state):
            _s.pop("fwd").__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        if backward:
            def bpre(m, grad_out, _s=state):
                _s["bwd"] = span(name)
                _s["bwd"].__enter__()

            def bpost(m, grad_in, grad_out, _s=state):
                if "bwd" in _s:
                    _s.pop("bwd").__exit__(None, None, None)

            handles += [mod.register_full_backward_pre_hook(bpre),
                        mod.register_full_backward_hook(bpost)]
    return handles


def _start():
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if card else []))
    prof.__enter__()
    return prof, time.perf_counter()


def _stop(prof, t0: float) -> Dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    return {"events": prof.profiler.kineto_results.events(), "window_s": window_s}


@contextlib.contextmanager
def traced():
    """Profile the block (host, and the card where there is one); yields a
    dict that holds, after the block, ``events`` (the kineto events) and
    ``window_s`` (host clock)."""
    out: Dict = {}
    prof, t0 = _start()
    try:
        yield out
    finally:
        out.update(_stop(prof, t0))


class CallStretch:
    """A traced stretch of whole calls, on the thread that makes them (the
    profiler records the host ranges of the thread that starts it).

    The caller calls :meth:`enter` at the entry of each call. Once
    ``armed`` is set, the entry after ``skip`` more calls starts the
    profiler (the calls that follow a loop's start carry its transient);
    the first entry
    after at least ``seconds`` and ``min_calls`` calls stops it, so the
    stretch holds whole periods of call and gap between calls, and then
    calls ``on_stop`` and sets ``done``. ``result`` then holds ``events``
    and ``window_s``.
    """

    def __init__(self, seconds: float, min_calls: int = 2, skip: int = 1, on_stop=None):
        self.seconds, self.min_calls, self.skip, self.on_stop = seconds, min_calls, skip, on_stop
        self.armed = False
        self.active = False
        self.calls = 0
        self.result: Dict = {}
        self.done = threading.Event()
        self._prof = None

    def enter(self) -> bool:
        """At a call's entry; returns whether this call is traced."""
        if self.active and self.calls >= self.min_calls and (
                time.perf_counter() - self._t0 >= self.seconds):
            self.active = False
            self.result = _stop(self._prof, self._t0)
            if self.on_stop is not None:
                self.on_stop()
            self.done.set()
        elif self.armed and not self.active and not self.done.is_set():
            if self.skip > 0:
                self.skip -= 1
            else:
                self._prof, self._t0 = _start()
                self.active = True
        if self.active:
            self.calls += 1
        return self.active


def reduce(events, window_s: float, top: int = 10) -> Dict:
    """Busy seconds, launches, device seconds per span, the ``top`` device
    operations by time and the ``top`` idle gaps (summed by the host range
    open at the gap's start)."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith("ProfilerStep#"):
                continue
            dev.append(e)
        else:
            cpu.append(e)
    intervals = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev]
    busy = union_seconds(intervals)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e9

    # spans: host ranges by thread and name; a kernel's launch is the runtime
    # call (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync...) of its
    # correlation id; a kernel counts for every span its launch lies in
    spans: Dict[tuple, List] = {}
    launches = {}
    for e in cpu:
        if e.name().startswith(SPAN_PREFIX):
            spans.setdefault((e.start_thread_id(), e.name()[len(SPAN_PREFIX):]), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    for v in spans.values():
        v.sort()
    span_starts = {k: [a for a, _ in v] for k, v in spans.items()}
    span_s: Dict[str, float] = {}
    for e in dev:
        hit = launches.get(e.correlation_id())
        if hit is None:
            continue
        tid, t = hit
        for (stid, name), v in spans.items():
            if stid != tid:
                continue
            j = bisect.bisect_right(span_starts[(stid, name)], t) - 1
            if j >= 0 and v[j][1] >= t:
                span_s[name] = span_s.get(name, 0.0) + e.duration_ns() / 1e9

    # the longest idle gaps, named by the innermost benchmark span and the
    # innermost host event open when each starts
    host = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in cpu
                   if e.duration_ns() > 0), key=lambda r: r[0])
    starts = [r[0] for r in host]
    found, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            found.append((a - end, end))
        end = b if end is None else max(end, b)
    gaps: Dict[str, float] = {}
    for length, at in sorted(found, reverse=True)[:GAPS_LABELLED]:
        i = bisect.bisect_right(starts, at)
        inner = sorted((r for r in host[max(0, i - 4000):i] if r[1] >= at),
                       key=lambda r: r[1] - r[0])
        names = [r[2] for r in inner if r[2].startswith(SPAN_PREFIX)]
        label = (f"{names[0][len(SPAN_PREFIX):] if names else '-'}: "
                 f"{inner[0][2] if inner else 'no host event'}")
        gaps[label] = gaps.get(label, 0.0) + length / 1e9
    return {"busy_s": busy, "window_s": window_s, "launches": len(dev), "span_s": span_s,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top]}
