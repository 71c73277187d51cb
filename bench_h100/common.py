"""What both kinds of cell share: the device, the seeded weights, the traced
window's per-layer context."""

from __future__ import annotations

import gc
import time

import torch

from bench_h100.reference.nets import calibrate, seeded_params

#: seconds of the traced stretch that follows the measured window in a ``--trace 1`` run
TRACE_SECONDS = 3.0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def seeded_weights(model, cfg, seed: int, device, calibrated: bool):
    """The model's tensors by state-dict name, made on ``device`` from
    ``seed`` (and, with ``calibrated``, every BatchNorm's running statistics
    set by the reference on seeded crops) and loaded into ``model``; returns
    the dict, which the reference uses as it is, the (name, shape) list, and
    the seconds the reference's calibration took, which are the benchmark's
    own work and left out of ``setup_s``."""
    shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")]
    params = seeded_params(shapes, seed, device)
    calibration_s = 0.0
    if calibrated:
        sync(device)
        t = now()
        calibrate(params, cfg, seed, device)
        sync(device)
        calibration_s = now() - t
    model.load_state_dict(params, strict=False)
    return params, shapes, calibration_s


def free(device) -> None:
    """Release what the program held, so the reference that follows fits."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0
