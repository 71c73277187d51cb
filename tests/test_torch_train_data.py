"""The port's training data path against the JAX package's, on the same data.

On ``make_synthetic_coco`` train trees written here (17 joints, up to 9
persons an image, 320x240 images):

* ``train_batches``: the item sequences and buckets of several epochs equal
  in all four ``PATCH_MODE``s (``random``, ``random_totally``, ``window``,
  ``main_target``), the trailing batch wrapped;
* ``select_data`` (``DATASET.SELECT_DATA``): the same db;
* ``make_raw_batch`` with ``is_train``: every array and the meta at several
  seeds, ``np.random`` seeded alike before each call (the half-body choice
  draws from it): rotation, flips, half-body (forced on in one case) and a
  pre-scaled image (a raster smaller than the images); uint8, bool and
  ``person_valid`` exactly, floats within 1e-6;
* ``device_batch`` of a rotated batch (the gather crop) against the JAX
  ``device_batch``: masks, targets and weights within atol 1e-5 / rtol 1e-4,
  validity equal, crops within rtol 1e-4 and atol ``chip_smoke.CROP_ATOL``:
  the 1e-4 of ``test_torch_modules.py::test_preprocess_inputs`` plus one
  float32 ulp of a source coordinate on a 640-pixel raster (2^-14 px) times
  the steepest step of a normalised crop (one pixel over the least ImageNet
  std). The two sides round the inverse affine's translation (``a_inv @ b``,
  hundreds of pixels here, on a 40x56 raster there) one ulp apart now and
  then (3.1e-5 px at 320x240), and a crop sample on an edge of the drawn
  figures moves by up to 4.4 normalised units a pixel;
* ``core/trainer.py::epoch_batches`` at ``WORKERS`` 0 against the JAX
  trainer's composition (``i2rnet_tpu/core/trainer.py:114-130``): the same
  records (``data/train_record.py``); at ``WORKERS`` 2 the same items;
* one Adam step of the tiny W48 model on a dataset batch against JAX
  ``make_train_step`` (``test_torch_train_step.py::check_train_step``, its
  tolerances);
* ``train_loop(cfg, out, device="cpu")`` with no ``batches``: trains from the
  dataset ``cfg`` names, validates ``TEST_SET``, resumes exactly.
"""

import json

import numpy as np
import pytest
import torch

from i2rnet_tpu.data.coco import COCODataset as JaxCOCO
from i2rnet_tpu.data.synthetic import make_synthetic_coco
from i2rnet_tpu.presets import tiny_test_config
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.trainer import epoch_batches, train_loop
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.data.train_record import batch_record, compare_records, train_records
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from chip_smoke import CROP_ATOL
from test_torch_bridge import random_variables, tiny_jax_model
from test_torch_train_step import check_train_step, jax_dropout_zero  # noqa: F401
from test_torch_validate import assert_same

import torch_fixture

torch.set_num_threads(2)

FLOATS = ("crop_affines", "mask_affines", "boxes", "joints_hm", "joints_vis")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tree = str(tmp_path_factory.mktemp("train17"))
    make_synthetic_coco(tree, num_images=10, num_joints=17, max_persons=9,
                        image_set="train2017", seed=4)
    return make_synthetic_coco(tree, num_images=4, num_joints=17, max_persons=3,
                               image_set="val2017", seed=5)


def configs(root, num_joints=17, **changes):
    """The JAX tiny config reading the tree at ``root`` (train2017 and
    val2017) with ``changes`` (``"SECTION.KEY": value``), and the port's."""
    cfg = tiny_test_config(num_joints).clone()
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TRAIN_SET = "train2017"
    cfg.DATASET.TEST_SET = "val2017"
    cfg.DATASET.MAX_PATCH = 4
    cfg.TPU.MAX_IMAGE_HW = (256, 320)
    cfg.TEST.BLUR_KERNEL = 5
    for key, v in changes.items():
        sec, k = key.split(".")
        setattr(getattr(cfg, sec), k, v)
    return cfg, presets.from_config(cfg)


def datasets(root, is_train=True, num_joints=17, **changes):
    jcfg, tcfg = configs(root, num_joints, **changes)
    split = "train2017" if is_train else "val2017"
    return (jcfg, JaxCOCO(jcfg, root, split, is_train=is_train),
            tcfg, COCODataset(tcfg, root, split, is_train=is_train))


def plain_items(batches):
    return [([(int(i), [int(p) for p in g]) for i, g in items], int(nb)) for items, nb in batches]


@pytest.mark.parametrize("mode", ["random", "random_totally", "window", "main_target"])
def test_train_batches_match_jax(root, mode):
    """Three epochs' orders and patch choices at three batch sizes (3 leaves
    a trailing batch to wrap); ``window`` pre-splits crowded images in the db."""
    _, jds, _, tds = datasets(root, **{"DATASET.PATCH_MODE": mode})
    assert tds.upper_body_ids == jds.upper_body_ids and tds.lower_body_ids == jds.lower_body_ids
    assert len(tds) == len(jds) and max(len(r["annos"]) for r in tds.db) > (
        4 if mode != "window" else 3)
    for seed in (0, 1, 2):
        for b in (2, 3, 4):
            got = plain_items(tds.train_batches(b, np.random.RandomState(seed)))
            want = plain_items(jds.train_batches(b, np.random.RandomState(seed)))
            assert got == want, (seed, b)
            assert all(len(items) == b and nb == 4 for items, nb in got)
    shards = [plain_items(tds.train_batches(2, np.random.RandomState(7), i, 2)) for i in (0, 1)]
    assert shards == [plain_items(jds.train_batches(2, np.random.RandomState(7), i, 2))
                      for i in (0, 1)]


def test_select_data_matches_jax(root):
    """The filtered train db equals JAX's; so does the filter of a db whose
    every other box center is moved off its joints, which drops persons."""
    _, jds, _, tds = datasets(root, **{"DATASET.SELECT_DATA": True})
    _, jfull, _, full = datasets(root)
    assert_same(tds.db, jds.db, "db")
    moved = [{**r, "annos": [{**a, "center": a["center"] + (40.0 * (k % 2), 25.0 * (k % 3))}
                             for k, a in enumerate(r["annos"])]} for r in full.db]
    kept = tds.select_data(moved)
    assert_same(kept, jfull.select_data(moved), "select_data")
    assert 0 < sum(len(r["annos"]) for r in kept) < sum(len(r["annos"]) for r in moved)


def assert_raw_equal(got, want, what):
    (graw, gmeta), (wraw, wmeta) = got, want
    assert set(graw) == set(wraw)
    for k in ("images", "person_valid"):
        assert graw[k].dtype == wraw[k].dtype, (what, k)
        np.testing.assert_array_equal(graw[k], wraw[k], err_msg=f"{what} {k}")
    for k in FLOATS:
        np.testing.assert_allclose(graw[k], wraw[k], rtol=0, atol=1e-6, err_msg=f"{what} {k}")
    for k in ("center", "scale", "joints", "joints_vis", "rotation", "score"):
        np.testing.assert_allclose(gmeta[k], wmeta[k], rtol=0, atol=1e-6, err_msg=f"{what} {k}")
    np.testing.assert_array_equal(gmeta["image_id"], wmeta["image_id"])
    assert gmeta["image_path"] == wmeta["image_path"]


RAW_CASES = {
    "recipe": {},
    "half_body": {"DATASET.PROB_HALF_BODY": 1.0, "DATASET.NUM_JOINTS_HALF_BODY": 3},
    "prescaled": {"TPU.MAX_IMAGE_HW": (200, 240)},
}


@pytest.mark.parametrize("case", list(RAW_CASES))
def test_make_raw_batch_matches_jax(root, case):
    """Eight seeds of augmentation on one batch: some rotated, some flipped
    (a negative x scale in the crop affine), half-body crops where forced."""
    _, jds, _, tds = datasets(root, **RAW_CASES[case])
    items, nb = next(jds.train_batches(4, np.random.RandomState(3)))
    rotated = flipped = 0
    for seed in range(8):
        np.random.seed(100 + seed)
        want = jds.make_raw_batch(items, nb, np.random.RandomState(seed))
        np.random.seed(100 + seed)
        got = tds.make_raw_batch(items, nb, np.random.RandomState(seed))
        assert_raw_equal(got, want, f"seed {seed}")
        raw, meta = got
        rotated += int(np.any(meta["rotation"] != 0))
        flipped += int(np.any(raw["crop_affines"][raw["person_valid"]][:, 0, 0] < 0))
    assert rotated and flipped
    if case == "prescaled":
        assert not raw["images"][:, 200:].any() and not raw["images"][:, :, 240:].any()


def test_device_batch_of_a_rotated_batch_matches_jax(root):
    _, jds, _, tds = datasets(root)
    items, nb = next(jds.train_batches(3, np.random.RandomState(0)))
    raw, meta = jds.make_raw_batch(items, nb, np.random.RandomState(2))
    assert np.abs(meta["rotation"]).max() > 1  # the gather crop, not the axis-aligned one
    want = {k: np.asarray(v) for k, v in jds.device_batch(raw).items()}
    got = {k: v.numpy() for k, v in tds.device_batch(raw, "cpu").items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["images"], want["images"], rtol=1e-4, atol=CROP_ATOL)
    for k in set(want) - {"images", "person_valid"}:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["person_valid"], want["person_valid"])


def jax_composition(jcfg, jds, epoch, batch_images, n):
    """The JAX trainer's batches (``i2rnet_tpu/core/trainer.py:114-130``)."""
    np.random.seed(jcfg.SEED)
    out = []
    for idx, (items, nb) in enumerate(jds.train_batches(
            batch_images, np.random.RandomState(jcfg.SEED + 1000 + epoch))):
        rng = np.random.RandomState((jcfg.SEED + 1) * 100003 + epoch * 10007 + idx)
        out.append(batch_record(items, nb, jds.make_raw_batch(items, nb, rng)[0]))
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("epoch", [0, 3])
def test_trainer_batches_are_the_jax_composition(root, epoch):
    """``epoch_batches`` at WORKERS 0 gives the JAX trainer's batches; at
    WORKERS 2 (threads share the global ``np.random`` stream, so the
    half-body choice may differ) the same items in the same order."""
    jcfg, jds, tcfg, tds = datasets(root, **{"DATASET.PROB_HALF_BODY": 0.6,
                                             "DATASET.NUM_JOINTS_HALF_BODY": 3})
    want = jax_composition(jcfg, jds, epoch, 3, 4)
    assert compare_records(train_records(tcfg, tds, 3, 4, epoch), want, atol=0.0) == 0.0
    seen = []
    make = tds.make_raw_batch

    def spy(items, nb, rng=None):
        seen.append([[int(i), [int(p) for p in g]] for i, g in items])
        return make(items, nb, rng)

    tds.make_raw_batch = spy
    raws = list(epoch_batches({**tcfg, "WORKERS": 2}, tds, epoch, 3))[:4]
    assert sorted(map(str, seen[:4])) == sorted(str(r["items"]) for r in want)
    for raw, rec in zip(raws, want):  # in order: the rasters and the persons of each item
        assert batch_record([], 4, raw)["sha256"]["images"] == rec["sha256"]["images"]
        np.testing.assert_array_equal(raw["person_valid"].sum(1),
                                      [len(p) for _, p in rec["items"]])


def test_adam_step_on_a_dataset_batch_matches_jax(root, jax_dropout_zero):  # noqa: F811
    """``check_train_step`` on a training batch of the tree (the tiny model
    at 17 joints), rotated crops, half-body forced."""
    jcfg, jmodel = tiny_jax_model(use_pallas=True, num_joints=17)
    variables = random_variables(jmodel, jcfg, seed=3)
    _, _, _, tds = datasets(root, **{"DATASET.PROB_HALF_BODY": 1.0,
                                     "DATASET.NUM_JOINTS_HALF_BODY": 3})
    items, nb = next(tds.train_batches(2, np.random.RandomState(1)))
    np.random.seed(0)
    raw, meta = tds.make_raw_batch(items, nb, np.random.RandomState(6))
    assert np.abs(meta["rotation"]).max() > 1 and raw["person_valid"].sum() >= 3
    check_train_step(jcfg, jmodel, variables, raw)


def test_train_loop_trains_from_the_dataset(root, tmp_path):
    """No ``batches``: two epochs of the tree's train2017 (10 images, B=4:
    2 steps an epoch by the schedule, 3 batches with the wrapped one),
    val2017 validated after the second; AUTO_RESUME restores it exactly."""
    _, cfg = configs(root)
    cfg["TRAIN"]["BATCH_SIZE_PER_GPU"] = 4
    cfg["TEST"]["BATCH_SIZE_PER_GPU"] = 4
    cfg["WORKERS"] = 2
    seen = []
    state = train_loop(cfg, str(tmp_path), max_epochs=2, device="cpu", validate_every=2,
                       on_step=lambda e, i, mt: seen.append((e, i, float(mt["loss"]),
                                                             mt["data_time"], mt["batch_time"])))
    assert [(e, i) for e, i, *_ in seen] == [(e, i) for e in (0, 1) for i in range(3)]
    assert all(np.isfinite(v) and d >= 0 and b >= d for _, _, v, d, b in seen)
    assert state.step == 6 and state.schedule(2) < state.schedule(0)
    payload = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert payload["epoch"] == 1 and 0.0 <= payload["perf"] <= 1.0
    assert (tmp_path / "results" / "keypoints_val2017_results.json").exists()
    assert (tmp_path / "model_best.pth").exists()
    resumed = train_loop(cfg, str(tmp_path), max_epochs=2, device="cpu")
    assert resumed.step == 6
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k


def test_committed_training_records_are_the_ports(tmp_path):
    """The committed ``expected_train.json`` of each training split (JAX's
    batches) equals what the port's trainer makes on the committed tree."""
    for dataset, split in torch_fixture.TRAIN_SPLITS.items():
        tree = torch_fixture.FIXTURES / split["dir"]
        cfg = presets.w48_pure_en6(dataset)
        cfg["DATASET"]["ROOT"] = str(tree)
        from i2rnet_tpu_torch.registry import get_dataset_class
        ds = get_dataset_class(dataset)(cfg, str(tree), split["train"], is_train=True)
        want = json.loads((tree / "expected_train.json").read_text())
        assert (want["batch_images"], want["seed"], len(want["batches"])) == (
            torch_fixture.TRAIN_BATCH, cfg["SEED"], torch_fixture.TRAIN_BATCHES)
        got = train_records(cfg, ds, want["batch_images"], len(want["batches"]))
        assert compare_records(got, want["batches"], atol=1e-5) <= 1e-5, dataset
