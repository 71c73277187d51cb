"""The port's CrowdPose and OCHuman datasets, its registry, the W48 presets of
the three datasets and the vanilla model without a position embedding,
against the JAX package.

* The committed fixtures (``tests/torch_fixture.py::write_train_fixtures``:
  COCO's train split, CrowdPose's trainval and test, OCHuman's val and test
  range) are what the JAX makers write: regenerated into a temporary
  directory here, every annotation file, decoded digest and expected record
  equal.
* On that regenerated tree: the dbs of every split equal the JAX datasets'
  (``crowdpose``, ``OCHuman``, ``coco_ochuman``; train and test), and
  ``validate`` with the GT-heatmap oracle gives the JAX ``validate``'s stats
  within 1e-6 (CrowdPose's AP easy, medium and hard among them) and the
  committed ``expected.json``.
* ``registry.get_dataset_class``: the four names, and the JAX KeyError text.
* ``presets.w48_pure_en6(dataset)`` equals the JAX preset of that dataset
  with its recipe's YAML merged over it (and ``load_config`` of the YAML).
* The tiny vanilla model with ``USE_MULTI_POS`` false: no position
  embedding, the same heatmaps as the JAX model (atol 1e-5 / rtol 1e-4, as
  ``test_torch_pure_multi.py``), the ``convert_state_dict`` round trip bit
  for bit.
* ``train_loop`` from the CrowdPose and OCHuman trees at the tiny width (14
  and 17 joints): finite losses, the test split validated.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from i2rnet_tpu.config import load_config
from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.validate import validate as jax_validate
from i2rnet_tpu.presets import tiny_test_config
from i2rnet_tpu.presets import w48_pure_en6 as jax_w48
from i2rnet_tpu.registry import get_dataset_class as jax_dataset_class
from i2rnet_tpu.registry import get_model_builder
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.core.trainer import joints_weight_for, train_loop
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.models.pure_multi import build_pure_multi
from i2rnet_tpu_torch.registry import get_dataset_class
from test_torch_bridge import random_variables
from test_torch_validate import assert_same

import torch_fixture

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
#: (dataset, fixture tree, split) of every db compared
SPLITS = [("crowdpose", "crowdpose_synth", "trainval"), ("crowdpose", "crowdpose_synth", "test"),
          ("OCHuman", "ochuman_synth", torch_fixture.TRAIN_SPLITS["OCHuman"]["train"]),
          ("OCHuman", "ochuman_synth", torch_fixture.TRAIN_SPLITS["OCHuman"]["test"]),
          ("coco_ochuman", "ochuman_synth", torch_fixture.TRAIN_SPLITS["OCHuman"]["test"]),
          ("coco", "coco_synth", "train2017")]


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fixtures")
    torch_fixture.write_train_fixtures(tmp)
    return tmp


@pytest.mark.parametrize("dataset", list(torch_fixture.TRAIN_SPLITS))
def test_fixtures_regenerate(regenerated, dataset):
    """Every file the generator writes for ``dataset``, and each image's
    decoded digest, equal to the committed ones."""
    split = torch_fixture.TRAIN_SPLITS[dataset]
    got, want = regenerated / split["dir"], torch_fixture.FIXTURES / split["dir"]
    for name in split["files"]:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    images = Path("images") / ("train2017" if dataset == "coco" else "")
    assert torch_fixture.decoded_digests(got, images) == torch_fixture.decoded_digests(want, images)


def both_configs(dataset, root, **changes):
    """The JAX W48 recipe config of ``dataset`` reading ``root`` and the
    port's (``from_config``), with ``changes``."""
    jcfg = torch_fixture.recipe_cfg("OCHuman" if dataset == "coco_ochuman" else dataset,
                                    str(root))
    jcfg.DATASET.DATASET = dataset
    for key, v in changes.items():
        sec, k = key.split(".")
        setattr(getattr(jcfg, sec), k, v)
    return jcfg, presets.from_config(jcfg)


@pytest.mark.parametrize("dataset,tree,split", SPLITS)
def test_dbs_match_jax(regenerated, dataset, tree, split):
    root = regenerated / tree
    jcfg, tcfg = both_configs(dataset, root)
    train = split == jcfg.DATASET.TRAIN_SET
    jds = jax_dataset_class(dataset)(jcfg, str(root), split, is_train=train)
    tds = get_dataset_class(dataset)(tcfg, str(root), split, is_train=train)
    assert_same(tds.db, jds.db, "db")
    assert len(tds) > 0 and tds.num_joints == jds.num_joints
    for k in ("flip_pairs", "upper_body_ids", "lower_body_ids", "joints_weight",
              "detail_cluster_mode", "_skip_scoring"):
        a, b = getattr(tds, k), getattr(jds, k)
        assert (a() == b()) if callable(a) else (list(a or ()) == list(b or ())), k
    assert Path(tds.db[0]["image"]).exists()


@pytest.mark.parametrize("dataset,tree", [("crowdpose", "crowdpose_synth"),
                                          ("OCHuman", "ochuman_synth"),
                                          ("coco_ochuman", "ochuman_synth")])
def test_validate_with_the_gt_oracle_matches_jax(regenerated, tmp_path, dataset, tree):
    root = regenerated / tree
    jcfg, tcfg = both_configs(dataset, root)
    test_set = jcfg.DATASET.TEST_SET
    jds = jax_dataset_class(dataset)(jcfg, str(root), test_set, is_train=False)
    tds = get_dataset_class(dataset)(tcfg, str(root), test_set, is_train=False)
    want, _ = jax_validate(jcfg, jds, None, None, str(tmp_path / "jax"),
                           eval_step_fn=lambda _v, batch: batch["target"])
    got, _ = validate(tcfg, tds, None, str(tmp_path / "port"), device="cpu",
                      eval_step_fn=lambda _m, batch: batch["target"])
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    expected = json.loads((torch_fixture.FIXTURES / tree / "expected.json").read_text())
    for k, v in expected["stats"].items():
        assert abs(got[k] - v) <= 1e-6, k
    if dataset == "crowdpose":
        assert {"AP (easy)", "AP (medium)", "AP (hard)"} <= set(got)
    assert got["AP"] > 0.95


def test_registry_names_and_error():
    for name, cls in (("coco", "COCODataset"), ("crowdpose", "CROWDPOSEDataset"),
                      ("OCHuman", "OCHumanDataset"), ("coco_ochuman", "CocoOCHumanDataset"),
                      ("mpii", "MPIIDataset")):
        assert get_dataset_class(name).__name__ == cls == jax_dataset_class(name).__name__
    with pytest.raises(KeyError) as got:
        get_dataset_class("mpii_typo")
    with pytest.raises(KeyError) as want:
        jax_dataset_class("mpii_typo")
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    assert str(got.value).endswith(
        "have ['OCHuman', 'coco', 'coco_ochuman', 'crowdpose', 'mpii']\"")


RECIPES = {"coco": "coco/interformer_coco_w48_pure_en6.yaml",
           "crowdpose": "crowdpose/interformer_crowdpose_w48_pure_en6.yaml",
           "OCHuman": "OCHuman/interformer_ochuman_w48_pure_en6.yaml"}


@pytest.mark.parametrize("dataset", list(RECIPES))
def test_w48_presets_are_the_jax_presets_with_the_yaml(dataset):
    """Every key of ``presets.w48_pure_en6(dataset)`` but ``DEVICE`` as
    ``from_config`` reads it from the JAX preset merged with the recipe's
    YAML, and from ``load_config`` of the YAML."""
    path = REPO / "experiments" / RECIPES[dataset]
    merged = jax_w48(dataset)
    merged.merge(yaml.safe_load(path.read_text()))
    want = presets.w48_pure_en6(dataset)
    for jcfg in (merged, load_config(str(path))):
        got = presets.from_config(jcfg)
        for sec in ("MODEL", "DATASET", "TEST", "TRAIN", "LOSS"):
            for k, v in want[sec].items():
                if k == "EXTRA":
                    for ek, ev in v.items():
                        assert got[sec][k][ek] == ev, (sec, ek)
                else:
                    assert got[sec][k] == v, (sec, k)
        for key in ("SEED", "AUTO_RESUME", "PRINT_FREQ", "WORKERS"):
            assert got[key] == want[key], key
    m, t = want["MODEL"], want["TRAIN"]
    assert (m["NUM_JOINTS"], want["DATASET"]["MAX_PATCH"], t["BATCH_SIZE_PER_GPU"], t["LR"],
            m["USE_MULTI_POS"]) == {"coco": (17, 7, 8, 5e-4, True),
                                    "crowdpose": (14, 5, 32, 1e-4, True),
                                    "OCHuman": (17, 3, 32, 1e-4, False)}[dataset]


def test_joints_weight_follows_the_dataset():
    cfg = presets.w48_pure_en6("crowdpose")
    assert joints_weight_for(cfg) is None
    cfg["LOSS"]["USE_DIFFERENT_JOINTS_WEIGHT"] = True
    assert joints_weight_for(cfg) == presets.CROWDPOSE_JOINTS_WEIGHT == \
        tuple(jax_dataset_class("crowdpose").joints_weight)
    cfg = presets.w48_pure_en6("OCHuman")
    cfg["LOSS"]["USE_DIFFERENT_JOINTS_WEIGHT"] = True
    assert joints_weight_for(cfg) == presets.COCO_JOINTS_WEIGHT
    tiny = presets.tiny_test_config(5)
    tiny["LOSS"]["USE_DIFFERENT_JOINTS_WEIGHT"] = True
    assert joints_weight_for(tiny) is None


@pytest.fixture(scope="module")
def no_pos():
    cfg = tiny_test_config(5)
    cfg.MODEL.USE_MULTI_POS = False
    jmodel = get_model_builder(cfg.MODEL.NAME)(cfg, use_pallas=True)
    variables = random_variables(jmodel, cfg, seed=6)
    return cfg, jmodel, variables


def test_no_position_embedding_matches_jax(no_pos, rng):
    cfg, jmodel, variables = no_pos
    assert "multi_pos" not in variables["params"]
    model = build_pure_multi(presets.from_config(cfg), device="cpu")
    assert model.position_embedding is None
    model.load_state_dict(params_from_jax(variables), strict=True)
    valid = np.array([[1, 1, 1], [1, 0, 0]], bool)
    images = rng.randn(2, 3, 64, 48, 3).astype(np.float32)
    pos = rng.rand(2, 3, 64, 48, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda *a: jmodel.apply(variables, *a, train=False)["multi"])(
        images, pos, valid))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (images, pos, valid))).numpy()
        moved = model(*map(torch.from_numpy, (images, rng.rand(*pos.shape).astype(np.float32),
                                              valid))).numpy()
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(moved, got)  # the box masks reach nothing
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, unmatched = convert_state_dict(sd, "interformer_pureMulti", strict=True)
    assert unmatched == []
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dataset,tree,joints", [("crowdpose", "crowdpose_synth", 14),
                                                 ("OCHuman", "ochuman_synth", 17)])
def test_train_loop_from_each_dataset(regenerated, tmp_path, dataset, tree, joints):
    """The tiny model (the dataset's joints, its recipe's MAX_PATCH and
    position embedding) trains one epoch of 2 steps from the tree and
    validates its test split."""
    root = regenerated / tree
    want = presets.w48_pure_en6(dataset)
    cfg = presets.tiny_test_config(joints)
    cfg["MODEL"]["USE_MULTI_POS"] = want["MODEL"]["USE_MULTI_POS"]
    cfg["DATASET"] = {**want["DATASET"], "ROOT": str(root)}
    cfg["TEST"]["BLUR_KERNEL"] = 5
    cfg["TRAIN"]["BATCH_SIZE_PER_GPU"] = 4
    cfg["WORKERS"] = 2
    losses = []
    state = train_loop(cfg, str(tmp_path), max_epochs=1, device="cpu",
                       on_step=lambda e, i, mt: losses.append(float(mt["loss"])))
    assert len(losses) == 3 and np.isfinite(losses).all() and state.step == 3
    assert (state.model.position_embedding is None) == (dataset == "OCHuman")
    results = json.loads((tmp_path / "results" /
                          f"keypoints_{want['DATASET']['TEST_SET']}_results.json").read_text())
    assert len(results) > 0 and all(len(r["keypoints"]) == 3 * joints for r in results)
