"""The benchmark's own tests: ``python -m pytest bench_h100 -q``.

On the CPU they hold the harness's data, traffic, arithmetic and import
rules, run every kind of cell end to end at tiny sizes (the port's tiny
presets, its plain kernel versions) against the reference, and see each
fault a cell can have come out not correct. The tests marked ``card`` run
the lower-precision control at the cells' own sizes and skip without a card.
"""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100 import flops, traffic
from bench_h100.run import forbidden_modules, run_cell
from bench_h100.spec import NAME, UNIT, Spec, name_errors

REPO = Path(__file__).resolve().parent.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 12345
#: each tiny cell: its configuration, its mix, and the benchmark cell whose
#: limits it takes (the training cell's limits below: BENCHMARK.json holds
#: no training cell, see PERF.md)
TINY = {"tiny-w48.serve": ("tiny-w48", "serve.crowdpose", "w48-crowdpose.serve.crowd"),
        "tiny-tph.serve": ("tiny-tph", "serve.coco", "tph-coco.serve.coco"),
        "tiny-w48.train": ("tiny-w48", "train.crowdpose", None)}
TRAIN_LIMITS = {"loss_gap": 0.003, "grad_gap": 0.1, "change_gap": 0.1}
TRAIN_METRICS = {
    "end_to_end": [{"name": "train_persons_s", "unit": "persons/s", "better": "higher",
                    "bound": 0.1, "source": "host_clock"}],
    "per_layer": [{"name": f"{m}.train", "unit": "%", "better": "higher",
                   "source": "device_trace", "layer": "device", "moves": "train_persons_s"}
                  for m in ("idle_share", "mfu", "attention_roofline", "launches_per_person")]}


def tiny_configs():
    from i2rnet_tpu_torch import presets

    out = {}
    for name, cfg in (("tiny-w48", presets.tiny_test_config()),
                      ("tiny-tph", presets.tiny_tph_config())):
        cfg["CUDNN"] = {"BENCHMARK": False, "DETERMINISTIC": False, "ENABLED": True}
        cfg["FLIP_PAIRS"] = [[1, 2], [3, 4]]
        cfg["TRAIN"]["BATCH_SIZE_PER_GPU"] = 2
        out[name] = cfg
    return out


def make_tree(root: Path) -> Spec:
    """A benchmark tree at ``root`` with the tiny cells: the port's tiny
    presets, the cells' mixes cut to tiny images, the cells' own limits."""
    bench = root / "bench_h100"
    shutil.copytree(REPO / "bench_h100", bench, ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in tiny_configs().items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    data = json.loads(json.dumps(BENCH))
    data["configs"] = [{"name": n, "source": "tiny", "file": f"bench_h100/configs/{n}.json",
                        "reduced": [], "why": "tiny"} for n in ("tiny-w48", "tiny-tph")]
    data["workloads"] = []
    for cell, (config, traffic_name, real) in TINY.items():
        mix = json.loads((bench / "traffic" / f"{traffic_name}.json").read_text())
        # a serving pool smaller than a call, as the cells' pools are
        mix.update(canvas_hw=[60, 80], pool=4 if mix["kind"] == "train" else 3)
        if mix["kind"] == "serve":
            mix.update(image_h=[40, 60], image_w=[50, 80], in_flight=8)
        else:
            mix.update(max_persons=3, upper_body=[0, 1, 2])
        (bench / "traffic" / f"tiny.{cell}.json").write_text(json.dumps(mix))
        if real:
            body = {"limits": json.loads((bench / "cells" / f"{real}.json").read_text())["limits"],
                    "batch_images": 4, "buckets": [2, 3], "check_requests": 6,
                    "peak_margin": 0.02}
        else:
            body = {"limits": TRAIN_LIMITS}
        (bench / "cells" / f"{cell}.json").write_text(json.dumps(body))
        data["workloads"].append({"name": cell, "config": config, "traffic": f"tiny.{cell}",
                                  "chips": 1, "why": "tiny"})
    for section in ("end_to_end", "per_layer"):
        for m in data[section]:
            if "workloads" in m:
                m["workloads"] = [c for c, (_, _, real) in TINY.items() if real in m["workloads"]]
        data[section] += [dict(m, workloads=["tiny-w48.train"]) for m in TRAIN_METRICS[section]]
    (root / "BENCHMARK.json").write_text(json.dumps(data, indent=1))
    return Spec(root, bench)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("bench"))


def run(spec, cell, trace=False, seconds=1.0):
    return run_cell(spec, cell, SEED, seconds, trace, "cpu", time.perf_counter())


# --- BENCHMARK.json ------------------------------------------------------------------------------

def test_names_units_and_keys():
    assert name_errors(BENCH) == []
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/") and (REPO / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert m["better"] in ("lower", "higher")
    spaced = {**BENCH, "workloads": [{"name": "a b", "config": "x", "traffic": "y"}]}
    assert name_errors(spaced) == ["workloads: name 'a b'"]


def test_every_moved_metric_is_reported():
    """A per-layer metric's ``moves`` is reported by every cell that reports the metric."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        spec = Spec(REPO)
        names = {m["name"] for m in spec.metrics(cell, traced=False)}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics(cell, traced=True)


def test_configs_are_the_recipes():
    """Each configuration is its recipe's YAML as the port reads it, nothing reduced."""
    from i2rnet_tpu_torch.config.config import load_config, to_port

    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        recipe = to_port(load_config(str(REPO / cfg["recipe"])))
        for section in ("MODEL", "DATASET", "TEST", "TRAIN", "LOSS", "DEVICE"):
            assert cfg[section] == recipe[section], (c["name"], section)
        assert c["reduced"] == cfg["reduced"] == []


# --- traffic ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("name,mean", [("serve.crowdpose", 4.0), ("serve.coco", 2.71)])
def test_serve_traffic_is_seeded_and_has_its_mean(name, mean):
    mix = json.loads((REPO / "bench_h100" / "traffic" / f"{name}.json").read_text())
    assert abs(traffic.pmf_mean(mix["persons_pmf"]) - mean) < 0.01
    small = {**mix, "pool": 64, "image_h": [40, 60], "image_w": [50, 80]}
    a, b = traffic.serve_requests(small, SEED), traffic.serve_requests(small, SEED)
    c = traffic.serve_requests(small, SEED + 1)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
    assert any(x[1] != y[1] for x, y in zip(a, c))
    counts = [len(r[1]) for r in traffic.serve_requests({**mix, "pool": 2000, "image_h": [40, 60],
                                                         "image_w": [50, 80]}, SEED)]
    assert abs(np.mean(counts) - mean) < 0.01 and max(counts) == 12
    assert sorted(len(r[1]) for r in a) == sorted(len(r[1]) for r in c)  # same work, new order
    for img, boxes in a:
        h, w = img.shape[:2]
        for x, y, bw, bh in boxes:
            assert 0 <= x and x + bw <= w and 0 <= y and y + bh <= h


def test_train_batches_are_seeded_and_capped(tree):
    cfg = tree.config("tiny-w48")
    mix = tree.traffic("tiny.tiny-w48.train")
    a = traffic.train_batches(mix, cfg, cfg["FLIP_PAIRS"], SEED)
    b = traffic.train_batches(mix, cfg, cfg["FLIP_PAIRS"], SEED)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    counts = np.concatenate([r["person_valid"].sum(1) for r in a])
    assert counts.max() <= mix["max_persons"] and counts.min() >= 1


# --- arithmetic ------------------------------------------------------------------------------------

def test_attention_hand_counts():
    assert flops.attention_work(10, 4) == (2 * (4 * 10 * 16 + 2 * 100 * 4), 3 * 10 * 4 * 2)
    assert flops.weight_bytes(4) == (64 + 16) * 4
    cfg = {"MODEL": {"NAME": "interformer_pureMulti", "TRANS_SIZE": [2, 3], "DIM_MODEL": 8,
                     "N_HEAD": 1, "ENCODER_LAYERS": 2}}
    # one call of rows with 1 and 2 persons: S = 6 and 12 tokens, C = 8
    fl = 2 * (4 * 18 * 64 + 2 * (36 + 144) * 8)
    nb = 3 * 18 * 8 * 2 + (4 * 64 + 32) * 4
    want = 2 * 2 * max(fl / flops.PEAK_BF16, nb / flops.PEAK_BYTES)
    assert math.isclose(flops.attention_bound(cfg, [[1, 2]], passes=2), want)


def shapes_of(cfg):
    from i2rnet_tpu_torch.models.interformer import build_model

    model = build_model(cfg, device="cpu")
    return model, [(k, tuple(v.shape)) for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked")]


def test_row_flops_hand_count_of_the_mask():
    """Two persons in a row cost twice one, plus the attention between them:
    4 S^2 C a layer more (QK and PV), S = 12 tokens a person, C = 16, 2 layers."""
    cfg = tiny_configs()["tiny-w48"]
    _, shapes = shapes_of(cfg)
    extra = flops.row_flops(cfg, shapes, 2) - 2 * flops.row_flops(cfg, shapes, 1)
    assert extra == 2 * 2 * 2 * 16 * (24 ** 2 - 2 * 12 ** 2)


@pytest.mark.parametrize("name", ["tiny-w48", "tiny-tph"])
def test_row_flops_equal_the_ports_count(name):
    """The reference's count equals FlopCounterMode over the port's own
    forward, but for the two-stage model's first-stage head (a 1x1 conv, 16
    to 5 channels over 16 x 12, for each of 3 persons), whose heatmaps a
    served request never reads."""
    cfg = tiny_configs()[name]
    model, shapes = shapes_of(cfg)
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(1, 3, h, w, 3), torch.zeros(1, 3, h, w, 1),
              torch.ones(1, 3, dtype=torch.bool))
    unread = 2 * 16 * 5 * 16 * 12 * 3 if name == "tiny-tph" else 0
    assert flops.row_flops(cfg, shapes, 3) == counter.get_total_flops() - unread


def test_call_stretch_traces_whole_calls_on_the_calling_thread():
    """The stretch starts at a call's entry after the skipped ones, holds at
    least two whole calls, records the host ranges of the thread that makes
    the calls, and stops at a later call's entry."""
    from bench_h100 import trace

    stretch = trace.CallStretch(0.05, min_calls=2, skip=1)
    stopped = []
    stretch.on_stop = lambda: stopped.append(threading.get_ident())
    made = []

    def caller():
        for i in range(100):
            if stretch.enter():
                made.append(i)
                with trace.span(f"call{i}"):
                    torch.ones(8) @ torch.ones(8)
                    time.sleep(0.01)
            if stretch.done.is_set():
                return

    stretch.armed = True
    worker = threading.Thread(target=caller)
    worker.start()
    worker.join()
    assert stretch.done.is_set() and stopped == [worker.ident]
    assert made[0] == 1 and len(made) == stretch.calls >= 2
    spans = sorted(e.name() for e in stretch.result["events"] if e.name().startswith("bench::"))
    assert spans == sorted(f"bench::call{i}" for i in made)
    assert stretch.result["window_s"] >= 0.05


# --- imports ---------------------------------------------------------------------------------------

def test_forbidden_names_are_whole_top_level_names():
    mods = ["i2rnet_tpu_torch", "i2rnet_tpu_torch.serving", "jaxlib.xla_client", "jax",
            "flaxen", "i2rnet_tpu.serving", "numpy", "jaxtyping"]
    assert forbidden_modules(mods) == ["i2rnet_tpu.serving", "jax", "jaxlib.xla_client"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "bench_h100" / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "contextlib", "math", "numpy", "torch",
                                         "bench_h100"), (path.name, mod)
            assert not mod.startswith("bench_h100.") or mod.startswith("bench_h100.reference")
    code = ("import sys, bench_h100.reference.nets, bench_h100.reference.serve, "
            "bench_h100.reference.train, bench_h100.reference.geometry; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'i2rnet_tpu_torch', 'i2rnet_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_imports_no_jax():
    """What a run imports, the program's modules with it, loads no JAX."""
    code = ("import sys, bench_h100.run, bench_h100.drive_serve, bench_h100.drive_train, "
            "bench_h100.control; import i2rnet_tpu_torch.serving, "
            "i2rnet_tpu_torch.models.interformer, i2rnet_tpu_torch.core.train, "
            "i2rnet_tpu_torch.core.trainer, i2rnet_tpu_torch.ops.preprocess; "
            "print(bench_h100.run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_without_a_card_or_the_program_no_result(tmp_path):
    """In a directory of BENCHMARK.json and bench_h100 only, and without a
    card, the run exits non-zero and prints no result line."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and "correct" not in out.stdout


# --- whole runs on the CPU -------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(TINY))
def test_a_sound_run_is_correct(tree, cell):
    line = run(tree, cell)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in tree.metrics(cell, traced=False)}
    assert list(line)[-1] == "compared"
    assert all(math.isfinite(v["value"]) for v in line["metrics"].values())


def test_serve_fault_an_answer_altered(tree, monkeypatch):
    """Each call's first two rows get each other's keypoints."""
    from i2rnet_tpu_torch import serving

    real = serving.Predictor._run

    def swapped(self, n, chunk):
        kp = real(self, n, chunk)
        if len(chunk) > 1:
            kp[[0, 1]] = kp[[1, 0]]
        return kp

    monkeypatch.setattr(serving.Predictor, "_run", swapped)
    assert not run(tree, "tiny-w48.serve")["correct"]


def test_train_fault_state_unchanged(tree, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line = run(tree, "tiny-w48.train")
    assert not line["correct"] and line["compared"]["change_gap"]["value"] == 1.0


def test_train_fault_half_the_batch_left_out(tree, monkeypatch):
    """The step sees the valid persons of the batch's first half only, the
    mean taken over them."""
    from i2rnet_tpu_torch.ops import preprocess

    real = preprocess.device_preprocess

    def halved(raw, *args, **kw):
        out = real(raw, *args, **kw)
        b = out["person_valid"].shape[0]
        keep = (torch.arange(b) < b // 2)[:, None].to(out["person_valid"].device)
        out["person_valid"] = out["person_valid"] & keep
        out["target_weight"] = out["target_weight"] * keep[..., None].float()
        return out

    monkeypatch.setattr(preprocess, "device_preprocess", halved)
    assert not run(tree, "tiny-w48.train")["correct"]


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    """A new configuration, mix, cell and per-layer metric, dropped in as
    files with their BENCHMARK.json entries, run with no harness edit."""
    spec = make_tree(tmp_path)
    bench = tmp_path / "bench_h100"
    cfg = json.loads((bench / "configs" / "tiny-w48.json").read_text())
    cfg["MODEL"]["ENCODER_LAYERS"] = 1
    (bench / "configs" / "tiny-w48-one.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny.tiny-w48.serve.json").read_text())
    mix["persons_pmf"] = [1.0]
    (bench / "traffic" / "tiny.single.json").write_text(json.dumps(mix))
    (bench / "cells" / "tiny-one.single.json").write_text(
        (bench / "cells" / "tiny-w48.serve.json").read_text())
    (bench / "metrics" / "persons_seen.serve.py").write_text(
        "def read(ctx):\n    return ctx['persons'] if ctx.get('kind') == 'serve' else None\n")
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tiny-w48-one", "source": "tiny",
                            "file": "bench_h100/configs/tiny-w48-one.json", "reduced": [],
                            "why": "tiny"})
    data["workloads"].append({"name": "tiny-one.single", "config": "tiny-w48-one",
                              "traffic": "tiny.single", "chips": 1, "why": "tiny"})
    for m in data["end_to_end"]:
        if "workloads" in m and "tiny-w48.serve" in m["workloads"]:
            m["workloads"].append("tiny-one.single")
    data["per_layer"].append({"name": "persons_seen.serve", "unit": "persons", "better": "higher",
                              "source": "program_counter", "layer": "micro-batching",
                              "moves": "serve_persons_s", "workloads": ["tiny-one.single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path, bench)
    line = run(spec, "tiny-one.single", trace=True)
    assert line["correct"] and line["metrics"]["persons_seen.serve"]["value"] > 0
    assert line["printed"]["traced_calls"] >= 2  # the batcher's own calls, traced
    assert "images_per_call.serve" not in line["metrics"]  # listed for other cells


# --- the control, on the card ----------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails the cell's limits on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from bench_h100.control import readings

    rows = readings(Spec(REPO), cell, [SEED, SEED + 1, SEED + 2], "cuda:0")
    assert not any(r["correct"] for r in rows), rows
