"""MPII (16 joints, PCKh) in the port against the JAX ``MPIIDataset``.

* The committed ``i2rnet_tpu_torch/data/fixtures/mpii_synth`` regenerates
  (``tests/torch_fixture.py::write_mpii``, the tree of
  ``tests/test_mpii.py::_make_mpii`` at seed 0): the annotation JSON and
  ``expected.json`` byte for byte, ``gt_valid.mat``'s arrays and each
  JPEG's decoded bytes equal.
* The db (centers moved and scaled, MATLAB's 1-based coordinates, one
  person an image) equals the JAX dataset's exactly.
* ``evaluate``'s PCKh table equals the JAX one's (atol 1e-9) on predictions
  spread from inside to outside the PCKh@0.5 radius, and the test split
  gives ``Null``.
* ``validate`` with the GT-heatmap oracle gives the JAX ``validate``'s table
  (atol 1e-9) and ``expected.json``; ``pred.mat`` is written.
"""

import json
import os

import numpy as np
import pytest
from scipy.io import loadmat

from i2rnet_tpu.core.validate import validate as jax_validate
from i2rnet_tpu.registry import get_dataset_class as jax_dataset_class
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.registry import get_dataset_class

import torch_fixture
from torch_fixture import MPII


def _configs(root=MPII):
    jcfg = torch_fixture.mpii_cfg(str(root))
    return jcfg, presets.from_config(jcfg)


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpii") / "mpii_synth"
    torch_fixture.write_mpii(root)
    return root


def test_fixture_regenerates(regenerated):
    for name in ("annot/valid.json", "expected.json"):
        assert (regenerated / name).read_bytes() == (MPII / name).read_bytes(), name
    got, want = (loadmat(str(r / "annot" / "gt_valid.mat")) for r in (regenerated, MPII))
    for k in ("dataset_joints", "jnt_missing", "pos_gt_src", "headboxes_src"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    images = torch_fixture.Path("images")
    assert (torch_fixture.decoded_digests(regenerated, images)
            == torch_fixture.decoded_digests(MPII, images)
            == (MPII / "decoded.sha256").read_text())


def test_db_matches_jax():
    jcfg, cfg = _configs()
    want = jax_dataset_class("mpii")(jcfg, str(MPII), "valid", is_train=False).db
    got = get_dataset_class("mpii")(cfg, str(MPII), "valid", is_train=False).db
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert (a["image"], a["image_id"], len(a["annos"])) == (b["image"], b["image_id"], 1)
        for k, v in b["annos"][0].items():
            np.testing.assert_array_equal(np.asarray(a["annos"][0][k]), np.asarray(v), err_msg=k)
            assert np.asarray(a["annos"][0][k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pckh_matches_jax(tmp_path, seed):
    jcfg, cfg = _configs()
    rng = np.random.RandomState(seed)
    gt = loadmat(str(MPII / "annot" / "gt_valid.mat"))
    pos_gt = np.transpose(gt["pos_gt_src"], [2, 0, 1])
    noise = rng.uniform(-1, 1, pos_gt.shape) * rng.choice([0.5, 5.0, 20.0], (len(pos_gt), 16, 1))
    preds = np.concatenate([pos_gt - 1.0 + noise, np.ones((*pos_gt.shape[:2], 1))], axis=2)
    want, want_perf = jax_dataset_class("mpii")(jcfg, str(MPII), "valid", False).evaluate(
        jcfg, preds.copy(), str(tmp_path / "jax"))
    got, perf = get_dataset_class("mpii")(cfg, str(MPII), "valid", False).evaluate(
        cfg, preds.copy(), str(tmp_path / "port"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-9, err_msg=k)
    assert perf == pytest.approx(float(want_perf), abs=1e-9) and 0.0 < perf < 100.0
    np.testing.assert_array_equal(loadmat(str(tmp_path / "port" / "pred.mat"))["preds"],
                                  loadmat(str(tmp_path / "jax" / "pred.mat"))["preds"])


def test_the_test_split_is_not_scored(tmp_path):
    _, cfg = _configs()
    cfg["DATASET"]["TEST_SET"] = "test"
    ds = get_dataset_class("mpii")(cfg, str(MPII), "valid", False)
    assert ds.evaluate(cfg, np.zeros((4, 16, 3)), str(tmp_path)) == ({"Null": 0.0}, 0.0)


def test_validate_with_the_oracle_matches_jax(tmp_path):
    jcfg, cfg = _configs()
    want, _ = jax_validate(jcfg, jax_dataset_class("mpii")(jcfg, str(MPII), "valid", False),
                           model=None, variables=None, output_dir=str(tmp_path / "jax"),
                           eval_step_fn=lambda _v, batch: batch["target"])
    got, perf = validate(cfg, get_dataset_class("mpii")(cfg, str(MPII), "valid", False), None,
                         str(tmp_path / "port"), eval_step_fn=lambda _m, batch: batch["target"],
                         device="cpu")
    expected = json.loads((MPII / "expected.json").read_text())["stats"]
    assert list(got) == list(want) and set(got) == set(expected)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(float(got[k]), expected[k], rtol=0, atol=1e-9, err_msg=k)
    assert perf == got["Mean"]
    assert os.path.exists(tmp_path / "port" / "pred.mat")
