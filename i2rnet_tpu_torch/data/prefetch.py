"""Background host-side batch prefetching.

Port of ``i2rnet_tpu/data/prefetch.py``: overlaps image decode and batch
assembly on the host with device compute (the reference's multi-worker
DataLoader, WORKERS=8). A pool of threads prepares ``(raw, meta)`` pairs
ahead of consumption, in order; copies to the device and the model stay on
the caller's thread. A worker's exception is raised on the consumer's side.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


def prefetch_batches(batch_iter: Iterator, make_batch: Callable,
                     num_workers: int = 4, buffer: int = 8):
    """Map ``make_batch(batch_index, items, n_bucket)`` over ``batch_iter``
    with worker threads, yielding results in order. ``batch_index`` lets the
    callee derive a deterministic per-batch seed (RandomState is not
    thread-safe)."""
    if num_workers <= 0:
        for i, (items, nb) in enumerate(batch_iter):
            yield make_batch(i, items, nb)
        return

    task_q: "queue.Queue" = queue.Queue(maxsize=buffer)
    out: dict = {}
    out_cond = threading.Condition()
    stop = threading.Event()

    def worker():
        while True:
            got = task_q.get()
            if got is None:
                return
            idx, items, nb = got
            if stop.is_set():
                continue  # drain without doing work
            try:
                result = make_batch(idx, items, nb)
            except Exception as e:  # surfaced on the consumer side
                result = e
            with out_cond:
                out[idx] = result
                out_cond.notify_all()

    workers = [threading.Thread(target=worker, daemon=True) for _ in range(num_workers)]
    for t in workers:
        t.start()

    def feeder():
        i = 0
        for items, nb in batch_iter:
            if stop.is_set():
                break
            while not stop.is_set():
                try:
                    task_q.put((i, items, nb), timeout=0.1)
                    i += 1
                    break
                except queue.Full:
                    continue
        with out_cond:
            out["total"] = i
            out_cond.notify_all()
        for _ in workers:
            task_q.put(None)

    feed = threading.Thread(target=feeder, daemon=True)
    feed.start()

    # an early-exiting consumer (break, max_batches) tears the workers down
    try:
        i = 0
        while True:
            with out_cond:
                while i not in out and out.get("total", -1) != i:
                    out_cond.wait(timeout=0.1)
                if out.get("total") == i and i not in out:
                    break
                result = out.pop(i)
            if isinstance(result, Exception):
                raise result
            yield result
            i += 1
    finally:
        stop.set()
        feed.join(timeout=10)
        for t in workers:
            t.join(timeout=10)
