"""The port's analysis tools against the JAX package's, on the CPU.

* FLOP formulas: each of the six eval ops' registered formula
  (``ops/cuda/library.py``) equals ``FlopCounterMode``'s count of the op's
  plain version on the same inputs, its depthwise 3x3 expressed as the
  grouped convolution it is (the plain version sums nine shifted products,
  which ``FlopCounterMode`` does not see; the formula counts their
  multiply-adds as the convolution would).
* ``compute_flops``: the count is the same with the kernels routed through
  their ops as on the modules, for the three tiny models; the tiny W48's
  GFLOPs lie within [0.8, 1.0] of the JAX tool's ``cost_analysis()`` of the
  same model (measured 0.883): XLA counts elementwise work too (BatchNorm,
  ReLU, softmax, LayerNorm, the residuals), ``FlopCounterMode`` products and
  convolutions only. The JSON carries the JAX tool's keys, ``--dataset``
  included.
* ``visualize``: the attention weights recorded through Kernel A's plain
  version equal the JAX tool's recorder on the same weights (atol 1e-6),
  layer for layer, and the grid has the JAX tool's layout.
* ``profile``: a Chrome trace of the eval and the train step.
* ``trans_json``, ``confirm_eval``, ``vis_demo`` and ``reproduce`` print what
  the JAX tools print on the same files, with the same exit codes; the
  drawn skeletons (Pillow against cv2) have the same files and sizes and
  agree on at least 95% of their pixels within 24 levels (JPEG, and the two
  libraries' discs and lines: measured 96.4% on the worst image).
"""

import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

import torch_fixture
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.cuda import encoder_ffn, hrformer_block, library, mhsa, mlp_dwbn
from i2rnet_tpu_torch.tools import (compute_flops, confirm_eval, profile, reproduce, trans_json,
                                    vis_demo, visualize)
from test_torch_bridge import port_model, random_variables, tiny_jax_model
from test_torch_tools import write_recipe

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
JAX_KEYS = ("model", "input", "batch_images", "persons_per_image", "gflops_per_batch",
            "gflops_per_person", "hbm_gb_per_batch", "latency_ms", "persons_per_sec",
            "fps_images", "tflops_per_sec")
JAX_DATASET_KEYS = ("protocol", "model", "dataset", "gflops_per_image_mean", "gflops_per_person",
                    "persons_total", "fps_images", "persons_per_sec")


def _count(fn, *args):
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


def _grouped_depthwise(h, dw):
    return F.conv2d(h.permute(0, 3, 1, 2), dw[:, None], padding=1,
                    groups=dw.shape[0]).permute(0, 2, 3, 1)


def _cases(g):
    def r(*s):
        return torch.randn(*s, generator=g)
    c, f, d, heads = 16, 32, 24, 2
    mask = torch.zeros(2, 30, dtype=torch.bool)
    mask[1, 20:] = True
    ffn = (torch.ones(c), torch.zeros(c), r(f, c), r(f), r(c, f), r(c), torch.ones(c),
           torch.zeros(c))
    attn = (torch.ones(c), torch.zeros(c), r(c, c), r(c), r(c, c), r(c), r(c, c), r(c), r(c, c),
            r(c))
    mlp = (torch.ones(c), torch.zeros(c), r(d, c), r(d), r(d, 3, 3), r(d), r(c, d), r(c))
    x = r(2, 9, 11, c)  # a map that pads to whole windows
    return {
        "masked_mhsa": (mhsa.masked_mhsa_torch, library.masked_mhsa,
                        (r(2, 30, c), r(2, 30, c), r(2, 30, c), heads, mask), ()),
        "encoder_ffn": (encoder_ffn.encoder_ffn_torch, library.encoder_ffn,
                        (r(3, 7, c), *ffn), ()),
        "window_attn_block": (hrformer_block.window_attn_block_torch, library.window_attn_block,
                              (x, *attn, heads, 7, 1e-6), ([],)),
        "mlp_block": (hrformer_block.mlp_block_torch, library.mlp_block, (x, *mlp, 1e-6), ([],)),
        "full_block": (hrformer_block.full_block_torch, library.full_block,
                       (x, *attn, *mlp, heads, 7, 1e-6), ([],)),
        "mlp_dwbn": (mlp_dwbn.mlp_dwbn_torch, library.mlp_dwbn, (x, *mlp[2:]), ([],)),
    }


@pytest.mark.parametrize("name", ["masked_mhsa", "encoder_ffn", "window_attn_block",
                                  "mlp_block", "full_block", "mlp_dwbn"])
def test_flop_formula_equals_the_plain_count(name, monkeypatch):
    monkeypatch.setattr(mlp_dwbn, "depthwise3x3", _grouped_depthwise)
    monkeypatch.setattr(hrformer_block, "depthwise3x3", _grouped_depthwise)
    plain, op, args, extra = _cases(torch.Generator().manual_seed(0))[name]
    want = _count(plain, *args)
    assert want > 0
    assert _count(op, *args, *extra) == want
    # what compute_flops counts: the route the models take, inside through_ops
    packed = {"packed": None if name == "full_block" else []} if extra else {}
    with library.through_ops():
        assert _count(lambda *a: library.route(name)(*a, **packed), *args) == want
    assert library.route(name) is library.ROUTES[name][0]


@pytest.mark.parametrize("name", ["tiny_test_config", "tiny_hrt_config", "tiny_tph_config"])
def test_compute_flops_counts_the_kernels(name):
    reports = []
    for kernels in (False, True):
        cfg = getattr(presets, name)()
        cfg["DEVICE"]["USE_KERNELS"] = kernels
        reports.append(compute_flops.measure(cfg, 2, 3, 1, "cpu"))
    assert reports[0]["gflops_per_batch"] == reports[1]["gflops_per_batch"] > 0
    assert set(JAX_KEYS) <= set(reports[1]) and reports[1]["device"] == "cpu"


def test_w48_gflops_within_the_band_of_jax_cost_analysis():
    import jax

    jcfg, jmodel = tiny_jax_model(use_pallas=False)
    variables = random_variables(jmodel, jcfg, seed=3)
    b, n = 2, 3
    w, h = jcfg.MODEL.IMAGE_SIZE
    rng = np.random.RandomState(0)
    images = rng.rand(b, n, h, w, 3).astype(np.float32)
    pos = (rng.rand(b, n, h, w, 1) > 0.5).astype(np.float32)
    valid = np.ones((b, n), bool)
    cost = jax.jit(lambda im, pm, v: jmodel.apply(variables, im, pm, v, train=False)).lower(
        images, pos, valid).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    model = port_model(variables, jcfg)
    cfg = presets.from_config(jcfg)
    flops, _ = compute_flops.count(compute_flops.forward_fn(cfg, model),
                                   *(torch.from_numpy(a) for a in (images, pos, valid)))
    assert 0.8 <= flops / float(cost["flops"]) <= 1.0, flops / float(cost["flops"])


def test_compute_flops_main_and_dataset_protocol(tmp_path, capsys):
    recipe = write_recipe(tmp_path / "tiny.yaml")
    argv = ["--cfg", str(recipe), "--device", "cpu", "--iters", "1"]
    report = compute_flops.main(argv + ["--batch", "2", "--persons", "2"])
    assert json.loads(capsys.readouterr().out) == report
    assert report["batch_images"] == 2 and report["gflops_per_person"] > 0
    report = compute_flops.main(argv + ["--dataset", "--num-samples", "3"])
    assert set(JAX_DATASET_KEYS) <= set(report) and report["dataset"] == "coco"
    assert report["protocol"].startswith("first 3 val images")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_visualize_records_what_the_jax_tool_records(tmp_path):
    import jax

    jcfg, jmodel = tiny_jax_model(use_pallas=False)
    variables = random_variables(jmodel, jcfg, seed=2)
    model = port_model(variables, jcfg)
    model.set_kernels(True)  # the recorded layers still run the plain attention
    rng = np.random.RandomState(1)
    images = rng.rand(1, 2, 64, 48, 3).astype(np.float32)
    pos = np.ones((1, 2, 64, 48, 1), np.float32)
    valid = np.array([[True, False]])
    jrec = _jax_tool("visualize").AttentionRecorder()
    with jrec, jax.disable_jit():
        want = jmodel.apply(variables, images, pos, valid, train=False)["multi"]
    with visualize.AttentionRecorder() as rec, torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (images, pos, valid)))
    assert len(rec.records) == len(jrec.records) == 2
    for a, b in zip(rec.records, jrec.records):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    with torch.no_grad():  # the recorder is gone after its block
        assert torch.equal(model(*(torch.from_numpy(a) for a in (images, pos, valid))), got)

    recipe = write_recipe(tmp_path / "tiny.yaml")
    image = next((torch_fixture.FIXTURE / "images" / "val2017").iterdir())
    records, grid = visualize.main(["--cfg", str(recipe), "--image", str(image), "--out",
                                    str(tmp_path / "vis.jpg"), "--device", "cpu"])
    assert len(records) == 2 and records[0].shape == (1, 2, 12, 12)
    np.testing.assert_allclose(records[-1].sum(-1), 1.0, atol=1e-5)
    assert grid.shape == (3 * 64, 6 * 48, 3)  # the crop and 17 joints, six a row
    assert Image.open(tmp_path / "vis.jpg").size == (6 * 48, 3 * 64)


@pytest.mark.parametrize("train", [False, True])
def test_profile_writes_a_trace(train, tmp_path):
    cfg = presets.tiny_hrt_config()
    cfg["DEVICE"]["REMAT"] = "layers"
    profile.trace(cfg, str(tmp_path), 1, train, 2, 2, "cpu")
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::convolution" in names
    assert ("autograd::engine::evaluate_function: CheckpointFunctionBackward" in names
            or any("backward" in str(n).lower() for n in names)) == train


def _run_jax(name, argv, capsys, monkeypatch):
    """A JAX tool's main in this process: (stdout, exit code)."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    code = 0
    try:
        runpy.run_path(str(REPO / "tools" / f"{name}.py"), run_name="__main__")
    except SystemExit as e:
        code = e.code or 0
    return capsys.readouterr().out, code


def _results(path, jitter, seed=0, drop=0):
    rng = np.random.RandomState(seed)
    ann = json.loads((torch_fixture.FIXTURE / torch_fixture.ANN).read_text())
    out = []
    for a in ann["annotations"][drop:]:
        kp = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
        kp[:, :2] += rng.randn(len(kp), 2) * jitter
        kp[:, 2] = rng.rand(len(kp))
        x, y, w, h = a["bbox"]
        out.append({"image_id": a["image_id"], "category_id": 1,
                    "keypoints": [round(float(v), 3) for v in kp.reshape(-1)],
                    "score": float(rng.rand()), "center": [x + w / 2, y + h / 2],
                    "scale": [w / 200, h / 200]})
    path.write_text(json.dumps(out))
    return path


@pytest.mark.parametrize("case", ["pass", "over_atol", "missing"])
def test_trans_json_matches_jax(case, tmp_path, capsys, monkeypatch):
    a = _results(tmp_path / "a.json", 2.0)
    b = _results(tmp_path / "b.json", 2.0 + (case == "over_atol") * 3.0,
                 drop=int(case == "missing"))
    argv = [str(a), str(b), "--atol", "5"]
    want = _run_jax("trans_json", argv, capsys, monkeypatch)
    code = trans_json.main(argv)
    assert (capsys.readouterr().out, code) == want
    assert want[1] == (0 if case == "pass" else 1)


@pytest.mark.parametrize("crowdpose", [False, True])
def test_confirm_eval_matches_jax(crowdpose, tmp_path, capsys, monkeypatch):
    res = _results(tmp_path / "r.json", 3.0, seed=2)
    argv = ["--results", str(res), "--ann", str(torch_fixture.FIXTURE / torch_fixture.ANN)]
    argv += ["--crowdpose"] if crowdpose else []
    want = _run_jax("confirm_eval", argv, capsys, monkeypatch)
    confirm_eval.main(argv)
    assert (capsys.readouterr().out, 0) == want
    assert "AP" in want[0]


def test_vis_demo_matches_jax(tmp_path, capsys, monkeypatch):
    res = _results(tmp_path / "r.json", 1.0, seed=3)
    root = torch_fixture.FIXTURE / "images" / "val2017"
    common = ["--results", str(res), "--image-root", str(root), "--limit", "4",
              "--score-thresh", "0.2"]
    out, code = _run_jax("vis_demo", common + ["--out-dir", str(tmp_path / "jax")], capsys,
                         monkeypatch)
    written = vis_demo.main(common + ["--out-dir", str(tmp_path / "port")])
    assert code == 0 and capsys.readouterr().out.replace("port", "jax") == out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(Path(p).name for p in written) == names and len(names) == 4
    for name in names:
        a, b = (np.asarray(Image.open(tmp_path / d / name).convert("RGB"), np.int32)
                for d in ("port", "jax"))
        assert a.shape == b.shape
        assert (np.abs(a - b).max(-1) <= 24).mean() >= 0.95, name


def test_reproduce_matches_jax(tmp_path, capsys, monkeypatch):
    """The same ``.pth`` (written by the port under the reference's names)
    through both tools: the same row, diff lines and exit codes, 0 within
    tolerance and 1 outside it; 2 without a checkpoint."""
    monkeypatch.chdir(tmp_path)
    recipe = write_recipe(tmp_path / "tiny_w48.yaml")
    cfg = to_port(load_config(str(recipe)))
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(4))
    torch.save(model.state_dict(), tmp_path / "model.pth")
    for expected, tol, code in (("AP=0.0,AR=0.0", 0.9, 0), ("AP=0.9", 0.01, 1)):
        argv = ["--cfg", str(recipe), "--checkpoint", str(tmp_path / "model.pth"),
                "--expected", expected, "--tol", str(tol), "--max-batches", "2"]
        want, want_code = _run_jax("reproduce", argv, capsys, monkeypatch)
        got_code = reproduce.main(argv + ["--device", "cpu"])
        got = capsys.readouterr().out
        assert got_code == want_code == code
        assert got[got.index("\ntiny_w48"):] == want[want.index("\ntiny_w48"):]
    assert reproduce.main(["--cfg", str(recipe), "--device", "cpu"]) == 2
