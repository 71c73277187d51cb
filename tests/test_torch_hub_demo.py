"""The serving slice's entry points on the CPU: ``tools.export``, ``hub`` and
``tools.demo``.

* ``tools.export.main`` from a recipe YAML and a checkpoint the port wrote,
  ``--device cpu``, with the kernels' ops (and ``--selftest``) and with
  ``--no-kernels`` (a program of plain PyTorch: no ``i2r::`` node): the
  loaded artifact answers as the in-process serve function over the
  checkpoint's weights, bit for bit (on the CPU both run the same plain
  PyTorch), as the JAX ``tests/test_tools.py::test_export_tool_roundtrip``;
* the ``hub`` loaders build what the JAX ``test_hub_loaders`` expects (17
  and 14 joints, ``d_model`` 96), and a ``.pth`` under the reference's names
  (``module.``-prefixed, as the reference saves) loads bit for bit;
* ``tools.demo`` on a fixture JPEG writes the drawn image and prints the
  ``Predictor``'s keypoints.
"""

import types

import numpy as np
import pytest
import torch
from PIL import Image

from i2rnet_tpu_torch import hub
from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.data.jpeg import imread
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.ops.cuda.library import graph_ops
from i2rnet_tpu_torch.presets import COCO_FLIP_PAIRS
from i2rnet_tpu_torch.serving import Predictor, load_predictor
from i2rnet_tpu_torch.tools import demo as demo_tool
from i2rnet_tpu_torch.tools import export as export_tool
from i2rnet_tpu_torch.utils.checkpoint import save_final_state
from test_torch_tools import write_recipe
from torch_fixture import FIXTURE

torch.set_num_threads(2)

IMAGE = FIXTURE / "images" / "val2017" / "000000000001.jpg"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(the tiny recipe, its port config, the model, its final_state.pth)."""
    tmp = tmp_path_factory.mktemp("export")
    recipe = write_recipe(tmp / "tiny_w48.yaml")
    # the recipes run the kernels (TPU.USE_PALLAS_ATTENTION true); --no-kernels turns them off
    recipe.write_text(recipe.read_text().replace("USE_PALLAS_ATTENTION: false",
                                                 "USE_PALLAS_ATTENTION: true"))
    cfg = to_port(load_config(str(recipe)))
    torch.manual_seed(11)
    model = build_model(cfg, device="cpu")
    path = save_final_state(str(tmp), types.SimpleNamespace(model=model))
    return recipe, cfg, model, path


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "no-kernels"])
def test_export_tool_round_trip(checkpoint, tmp_path, capsys, kernels):
    recipe, cfg, model, ckpt = checkpoint
    out = tmp_path / "model.i2rx"
    header = export_tool.main(
        ["--cfg", str(recipe), "--checkpoint", str(ckpt), "--out", str(out), "--batch", "1",
         "--persons", "2", "--raw-hw", "240", "320", "--device", "cpu",
         *(["--selftest"] if kernels else ["--no-kernels"])])
    assert ("selftest ok: keypoints (1, 17, 3)" in capsys.readouterr().out) == kernels
    ops = ["i2r::encoder_ffn", "i2r::masked_mhsa"] if kernels else []
    pred = load_predictor(str(out), device="cpu")
    assert header["kernels"] == pred.header["kernels"] == ops
    assert graph_ops(pred.programs[2].graph) == ops
    assert (pred.header["device"], pred.header["num_joints"], pred.batch_images) == ("cpu", 17, 1)

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    got = pred.predict([img], [[[4.0, 4.0, 40.0, 56.0]]])[0]
    # the same request through the in-process serve function over the checkpoint
    local = Predictor(model, cfg, COCO_FLIP_PAIRS, batch_images=1, n_buckets=(2,),
                      raw_hw=(240, 320))
    np.testing.assert_array_equal(got, local.predict([img], [[[4.0, 4.0, 40.0, 56.0]]])[0])


def test_hub_loaders():
    """The JAX ``test_hub_loaders``'s expectations, on the CPU."""
    model = hub.i2rnet_w48_pure("coco", device="cpu")
    assert model.final_layer.out_channels == 17 and not model.training
    assert next(model.parameters()).device.type == "cpu"
    model = hub.i2rnet_tph("crowdpose", device="cpu")
    assert model.final_layer.out_channels == 14
    assert model.singleformer.final_layer.out_channels == 14
    model = hub.transpose_h("coco", device="cpu")
    assert model.d_model == 96 and model.global_encoder.use_kernels
    with pytest.raises(KeyError, match="unknown dataset"):
        hub.i2rnet_tph("mpii", device="cpu")


def test_hub_loads_a_reference_pth_bit_for_bit(tmp_path):
    """A ``.pth`` as the reference writes it (``module.`` names, every
    parameter and buffer) loads into the hub's model exactly."""
    ref = hub.i2rnet_w48_pure("crowdpose", device="cpu")
    gen = torch.Generator().manual_seed(5)
    sd = {k: (torch.randn(v.shape, generator=gen).to(v.dtype) if v.is_floating_point() else v)
          for k, v in ref.state_dict().items()}
    path = tmp_path / "model_best.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    model = hub.i2rnet_w48_pure("crowdpose", checkpoint=str(path), device="cpu")
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_demo_draws_and_prints_the_predictors_keypoints(checkpoint, tmp_path, capsys):
    recipe, cfg, model, ckpt = checkpoint
    out = tmp_path / "demo.jpg"
    keypoints = demo_tool.main(["--image", str(IMAGE), "--boxes", "10,10,60,120", "5,20,40,80",
                                "--cfg", str(recipe), "--checkpoint", str(ckpt),
                                "--out", str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    rgb = imread(str(IMAGE), rgb=True)
    want = Predictor(model, cfg, COCO_FLIP_PAIRS, batch_images=1, n_buckets=(2,),
                     raw_hw=rgb.shape[:2]).predict([rgb], [[[10, 10, 60, 120], [5, 20, 40, 80]]])
    np.testing.assert_array_equal(keypoints, want[0])
    assert keypoints.shape == (2, 17, 3) and f"wrote {out}" in printed
    assert np.array2string(keypoints)[:20] in printed
    drawn = np.asarray(Image.open(out))
    assert drawn.shape == rgb.shape
