"""Run one cell of the benchmark once and print its result line.

    python3 -m bench_h100.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the mix's ``kind`` picks the
module that runs it, ``drive_<kind>.py`` (``drive_serve``, ``drive_train``).
The last line of standard output is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``compared``: each
number the correctness check compared, with its limit. The compared numbers
are also the last lines of standard error.

The run refuses to start without CUDA or with fewer cards than the cell asks
for, and refuses to print a result if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``i2rnet_tpu`` has been imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
#: the program's build caches, at fixed paths inside the checkout
CACHE = REPO / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "i2rnet_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, marks=None) -> dict:
    """Run ``workload`` once on ``device``; returns the result line as a dict.
    ``marks``: seconds of the process's first steps, printed with set-up's phases."""
    import torch

    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    torch.backends.cudnn.benchmark = bool(cfg["CUDNN"]["BENCHMARK"])
    torch.backends.cudnn.deterministic = bool(cfg["CUDNN"]["DETERMINISTIC"])
    runner = importlib.import_module(f"bench_h100.drive_{mix['kind']}")
    job = {"cfg": cfg, "mix": mix, "cell": spec.cell(workload), "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace), "device": device,
           "t_start": t_start, "marks": dict(marks or {})}
    res = runner.run(job)
    metrics = {}
    for m in spec.metrics(workload, traced=bool(trace)):
        if trace:
            value = spec.reader(m["name"])(res["ctx"])
        else:
            value = res["values"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "count": 1, "memory_peak_bytes": res["memory"]}}
    if trace:
        red = res["ctx"]["trace"]
        line["device"].update(busy_s=red["busy_s"], window_s=red["window_s"])
        line["breakdown"] = {"device_ops": [list(x) for x in red["device_ops"]],
                             "idle_gaps": [list(x) for x in red["idle_gaps"]]}
    line["printed"] = res["printed"]
    line["compared"] = res["compared"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from bench_h100.spec import Spec

    marks = {"torch_import_s": time.perf_counter() - T_START}
    spec = Spec(REPO)
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    marks["cuda_found_s"] = time.perf_counter() - T_START
    line = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                    T_START, marks)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"bench_h100: the run imported {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line, allow_nan=True, default=_plain))
    return 0


def _plain(x):
    if hasattr(x, "item"):
        return x.item()
    return float(x) if isinstance(x, float) and math.isfinite(x) else str(x)


if __name__ == "__main__":
    sys.exit(main())
