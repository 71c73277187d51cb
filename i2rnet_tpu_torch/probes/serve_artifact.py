"""Serve an artifact in a process of its own, as a deployment does.

    python3 -m i2rnet_tpu_torch.probes.serve_artifact ARTIFACT REQUESTS OUT \\
        [--device cuda|cpu] [--stream STREAM --stream-out STREAM_OUT]

``chip_smoke.py``'s serving phases run this in a fresh process. With
``jax``, ``flax``, ``yaml``, ``cv2`` and the JAX package blocked, it imports
``i2rnet_tpu_torch.serving`` only, loads ARTIFACT on the device (the card by
default; ``load_predictor``), warms every bucket, and serves the requests of
REQUESTS (an ``.npz`` of uint8 images ``image_<i>`` and ``boxes``, a JSON
list of each image's box lists) with each kernel's launches counted from
zero and the programs' calls counted per bucket. It writes the results
(``result_<i>``) and a JSON record of the counts and times to OUT (``.npz``)
and prints the record. It checks that no model module was imported, and, on
the card, that with the kernel library unavailable (no library built, no
``nvcc``) a request raises rather than run anything else.

With ``--stream`` it then waits for STREAM to appear: an ``.npz`` of images
and boxes as REQUESTS, ``arrivals`` (seconds from the start) and
``max_delay_ms``. It submits each request to a ``MicroBatcher`` at its
arrival time, then serves each again alone with ``predict``, and writes the
submit and done times, each ``predict`` call's images, and both results to
STREAM_OUT.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path


def _requests(path):
    import numpy as np

    req = np.load(path)
    boxes = json.loads(str(req["boxes"]))
    return req, [req[f"image_{i}"] for i in range(len(boxes))], boxes


def _save(path, **arrays):
    """``np.savez`` to a temporary name, then moved: a reader sees it whole."""
    import numpy as np

    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _refused_without_library(pred, images, boxes, build):
    """The error a request raises when no kernel library can be had, or None."""
    build.library.cache_clear()
    saved = build.BUILD_DIR, os.environ.get("CUDA_HOME"), os.environ.get("PATH", "")
    with tempfile.TemporaryDirectory() as empty:
        build.BUILD_DIR = Path(empty)
        os.environ["CUDA_HOME"], os.environ["PATH"] = empty, empty
        try:
            pred.predict(images[:1], boxes[:1])
            return None
        except RuntimeError as e:
            return str(e)[:200]
        finally:
            build.BUILD_DIR = saved[0]
            os.environ.pop("CUDA_HOME")
            if saved[1] is not None:
                os.environ["CUDA_HOME"] = saved[1]
            os.environ["PATH"] = saved[2]
            build.library.cache_clear()


def _stream(pred, path, out, sync):
    """The MicroBatcher run of ``--stream`` (see the module docstring)."""
    import numpy as np

    from i2rnet_tpu_torch.serving import MicroBatcher

    req, images, boxes = _requests(path)
    arrivals = req["arrivals"]
    groups, predict = [], pred.predict
    pred.predict = lambda im, bx: groups.append(len(im)) or predict(im, bx)
    n = len(images)
    done, submitted, futs = np.zeros(n), np.zeros(n), []
    mb = MicroBatcher(pred, max_delay_ms=float(req["max_delay_ms"]))
    start = time.perf_counter()
    try:
        for i, (img, bxs) in enumerate(zip(images, boxes)):
            wait = start + arrivals[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            submitted[i] = time.perf_counter()
            fut = mb.submit(img, bxs)
            fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append(fut)
        batched = [f.result(timeout=600) for f in futs]
    finally:
        mb.close()
        pred.predict = predict
    alone = [predict([img], [bxs])[0] for img, bxs in zip(images, boxes)]
    sync()
    _save(out, submitted=submitted, done=done, groups=np.asarray(groups),
          **{f"batched_{i}": r for i, r in enumerate(batched)},
          **{f"alone_{i}": r for i, r in enumerate(alone)})


def main(argv) -> int:
    for name in ("jax", "flax", "yaml", "cv2", "i2rnet_tpu"):
        sys.modules[name] = None
    p = argparse.ArgumentParser(description="serve an .i2rx artifact in a fresh process")
    p.add_argument("artifact")
    p.add_argument("requests")
    p.add_argument("out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--stream", default=None)
    p.add_argument("--stream-out", default=None)
    args = p.parse_args(argv)

    import torch

    from i2rnet_tpu_torch.ops.cuda import build, launch_counts, reset_launches
    from i2rnet_tpu_torch.serving import load_predictor

    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    pred = load_predictor(args.artifact, device)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred.warmup()
    warmup_s = time.perf_counter() - t0
    _, images, boxes = _requests(args.requests)

    calls, serve = {}, pred.serve

    def counted(*a):
        n = int(a[4].shape[1])
        calls[n] = calls.get(n, 0) + 1
        return serve(*a)

    pred.serve = counted
    reset_launches()
    t0 = time.perf_counter()
    results = pred.predict(images, boxes)
    sync()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    pred.serve = serve
    models = sorted(k for k in sys.modules if k.startswith("i2rnet_tpu_torch.models"))
    refused = _refused_without_library(pred, images, boxes, build)
    record = {"load_s": load_s, "warmup_s": warmup_s, "serve_s": serve_s,
              "calls": {str(n): c for n, c in sorted(calls.items())}, "launches": launches,
              "kernels": pred.header["kernels"], "models_imported": models,
              "refused_without_library": refused}
    _save(args.out, record=json.dumps(record),
          **{f"result_{i}": r for i, r in enumerate(results)})
    print(json.dumps(record), flush=True)
    if models or (refused is None and device.type == "cuda"):
        return 1
    if args.stream:
        deadline = time.monotonic() + 1800
        while not os.path.exists(args.stream):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {args.stream} within 1800 s")
            time.sleep(0.05)
        _stream(pred, args.stream, args.stream_out, sync)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
