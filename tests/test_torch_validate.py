"""The port's evaluation slice against the JAX package's, on the same data.

On ``make_synthetic_coco(num_joints=5)`` trees written here:

* ``COCODataset`` and ``PoseDataset``: the db records (GT-grouped, the
  ``window`` pre-split, detector boxes from a detections file), the
  ``eval_batches`` and ``eval_batches_main_target`` items and buckets, and
  every array of ``make_raw_batch`` (images included, shrunk to a smaller
  raster too, BGR and RGB): exactly equal.
* ``validate`` with the GT-heatmap oracle against the JAX ``validate`` with
  its oracle, in the default, ``main_target`` and detector-box modes: the
  same result entries in the same order, keypoints within 1e-3 px, scores
  within 1e-5, AP stats within 1e-6, AP > 0.95 on both sides. (The
  detector records carry no joints, so the test gives each the joints of
  the GT person its box was jittered from.)
* ``validate`` with the tiny seeded model against the JAX ``validate`` on the
  same weights (Pallas kernels in interpret mode): with ``POST_PROCESS``
  false every keypoint within 1e-3 px, confidences within atol 1e-5 /
  rtol 1e-4, and AP equal; with DARK on the rule of
  ``test_torch_serving.py::test_serve_matches_jax``, for its reason.
* ``DEVICE.EVAL_PIPELINE`` 0 and 8 give the same bytes.
* The committed fixture (``tests/torch_fixture.py``) regenerated: the same
  annotation bytes, decoded digests and JAX ``expected.json``; the port's
  oracle ``validate`` at the W48 config on it gives the JAX stats.
* ``train_loop`` with a validation dataset writes ``validate``'s AP as
  each checkpoint's ``perf``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from i2rnet_tpu.core.validate import validate as jax_validate
from i2rnet_tpu.data.coco import COCODataset as JaxCOCO
from i2rnet_tpu.data.synthetic import make_synthetic_coco, make_synthetic_detections
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.trainer import train_loop
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from test_torch_bridge import port_model, random_variables, tiny_jax_model

import torch_fixture

torch.set_num_threads(2)

RESULTS = Path("results") / "keypoints_val2017_results.json"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("val5")), num_images=8, num_joints=5,
                               max_persons=4, image_set="val2017", seed=1)


@pytest.fixture(scope="module")
def det_file(root):
    return make_synthetic_detections(root, image_set="val2017")


def configs(root, **changes):
    """The JAX tiny config reading the tree at ``root`` with ``changes``
    (``"SECTION.KEY": value``), and the port's (``from_config``)."""
    from i2rnet_tpu.presets import tiny_test_config

    cfg = tiny_test_config(5).clone()
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.TPU.MAX_IMAGE_HW = (256, 320)
    cfg.TEST.BLUR_KERNEL = 5
    cfg.TEST.BATCH_SIZE_PER_GPU = 3
    cfg.WORKERS = 2
    for key, v in changes.items():
        sec, k = key.split(".")
        setattr(getattr(cfg, sec), k, v)
    return cfg, presets.from_config(cfg)


def datasets(root, **changes):
    jcfg, tcfg = configs(root, **changes)
    return (jcfg, JaxCOCO(jcfg, root, "val2017", is_train=False),
            tcfg, COCODataset(tcfg, root, "val2017", is_train=False))


def assert_same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b and type(a) is type(b), (what, a, b)


MODES = {
    "gt": {},
    "gt_shrunk_bgr": {"TPU.MAX_IMAGE_HW": (200, 240), "DATASET.COLOR_RGB": False},
    "window": {"DATASET.PATCH_MODE": "window", "DATASET.MAX_PATCH": 2},
    "detector": {"TEST.USE_GT_BBOX": False, "TEST.IMAGE_THRE": 0.3},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_db_batches_and_raw_batches_match_jax(root, det_file, mode):
    changes = dict(MODES[mode])
    if mode == "detector":
        changes["TEST.COCO_BBOX_FILE"] = det_file
    _, jds, _, tds = datasets(root, **changes)
    assert_same(tds.db, jds.db, "db")
    assert len(tds.db) > 0
    if mode == "window":
        assert max(len(r["annos"]) for r in tds.db) == 2
    if mode == "detector":
        assert all(len(r["annos"]) == 1 for r in tds.db)
    assert tds.flip_pairs == jds.flip_pairs == [[1, 2], [3, 4]]
    for b in (3, 4):
        for jbatches, tbatches in ((jds.eval_batches(b), tds.eval_batches(b)),
                                   (jds.eval_batches_main_target(b),
                                    tds.eval_batches_main_target(b))):
            jb, tb = list(jbatches), list(tbatches)
            assert_same([[(int(i), None if p is None else [int(x) for x in p]) for i, p in items]
                         for items, _ in tb],
                        [[(int(i), None if p is None else [int(x) for x in p]) for i, p in items]
                         for items, _ in jb], "items")
            assert [n for _, n in tb] == [n for _, n in jb]
    for items, nb in list(jds.eval_batches(3)) + list(jds.eval_batches_main_target(4))[:2]:
        assert_same(tds.make_raw_batch(items, nb), jds.make_raw_batch(items, nb), "raw batch")
    if mode == "gt_shrunk_bgr":
        raw, _ = tds.make_raw_batch([(0, None)], 4)
        assert not raw["images"][0, 180:].any() and raw["images"][0, :180, :240].any()


def give_detections_gt_joints(ds, root):
    """Each detector record's joints: those of the GT person (same image) whose
    box overlaps its box most."""
    ann = json.loads((Path(root) / "annotations" / "person_keypoints_val2017.json").read_text())

    def iou(a, b):
        ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
        return ix * iy / (a[2] * a[3] + b[2] * b[3] - ix * iy)

    for rec in ds.db:
        a = rec["annos"][0]
        gt = max((g for g in ann["annotations"] if g["image_id"] == rec["image_id"]),
                 key=lambda g: iou(g["bbox"], a["box"]))
        kp = np.asarray(gt["keypoints"], np.float32).reshape(-1, 3)
        a["joints_3d"] = np.concatenate([kp[:, :2], np.zeros((len(kp), 1), np.float32)], 1)
        a["joints_3d_vis"] = np.repeat(np.minimum(kp[:, 2:], 1.0), 3, axis=1)


def compare_results(got_dir, want_dir, got_preds, want_preds):
    """The same entries in the same order; the predictions handed to
    ``evaluate`` within 1e-3 px and confidences within 1e-5; the entries'
    scores within 1e-5. The results file rounds keypoints and confidences
    to 1e-3, so there two values within 1e-3 may differ by 2e-3."""
    np.testing.assert_allclose(got_preds[..., :2], want_preds[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_preds[..., 2], want_preds[..., 2], atol=1e-5, rtol=0)
    got = json.loads((Path(got_dir) / RESULTS).read_text())
    want = json.loads((Path(want_dir) / RESULTS).read_text())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"], g["center"], g["scale"]) == \
               (w["image_id"], w["category_id"], w["center"], w["scale"])
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=2e-3 + 1e-9, rtol=0)
        assert abs(g["score"] - w["score"]) <= 1e-5
    return got


@pytest.mark.parametrize("mode", ["default", "main_target", "detector"])
def test_validate_with_the_gt_oracle_matches_jax(root, det_file, tmp_path, mode):
    """Targets rendered, decoded (DARK, blur 5), rescored, suppressed and
    scored on both sides."""
    changes = {"main_target": {"DATASET.PATCH_MODE": "main_target", "DATASET.MAX_PATCH": 2},
               "detector": {"TEST.USE_GT_BBOX": False, "TEST.COCO_BBOX_FILE": det_file,
                            "TEST.IMAGE_THRE": 0.3},
               "default": {}}[mode]
    jcfg, jds, tcfg, tds = datasets(root, **changes)
    if mode == "detector":
        give_detections_gt_joints(jds, root)
        give_detections_gt_joints(tds, root)
    jseen, tseen = spy_preds(jds), spy_preds(tds)
    want, _ = jax_validate(jcfg, jds, None, None, str(tmp_path / "jax"),
                           eval_step_fn=lambda _v, batch: batch["target"])
    got, _ = validate(tcfg, tds, None, str(tmp_path / "port"), device="cpu",
                      eval_step_fn=lambda _m, batch: batch["target"])
    np.testing.assert_array_equal(tseen[0][1], jseen[0][1])
    results = compare_results(tmp_path / "port", tmp_path / "jax", tseen[0][0], jseen[0][0])
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["AP"] > 0.95 and want["AP"] > 0.95
    if mode == "main_target":
        assert len(results) == sum(len(r["annos"]) for r in tds.db)


def spy_preds(ds):
    """Record the predictions ``validate`` hands to ``ds.evaluate``."""
    seen, evaluate = [], ds.evaluate

    def spy(cfg, preds, output_dir, all_boxes, image_ids):
        seen.append((np.array(preds), np.array(all_boxes)))
        return evaluate(cfg, preds, output_dir, all_boxes, image_ids)

    ds.evaluate = spy
    return seen


@pytest.fixture(scope="module")
def seeded():
    jcfg, jmodel = tiny_jax_model(use_pallas=True)
    variables = random_variables(jmodel, jcfg, seed=3)
    return jmodel, variables, port_model(variables, jcfg)


def test_validate_with_the_seeded_model_matches_jax(root, tmp_path, seeded):
    """Argmax decode: every keypoint within 1e-3 px, confidences within
    atol 1e-5 / rtol 1e-4, AP equal. DARK decode: confidences likewise, and
    coordinates within 1e-3 px wherever the JAX Taylor step stays within one
    heatmap pixel of the argmax; further away the Hessian at the argmax is
    near singular on these random-weight maps and f32 rounding decides the
    step on either side, so those are held finite."""
    jmodel, variables, model = seeded
    runs = {}
    for post in (False, True):
        jcfg, jds, tcfg, tds = datasets(root, **{"TEST.POST_PROCESS": post,
                                                 "TEST.BATCH_SIZE_PER_GPU": 8})
        jseen, tseen = spy_preds(jds), spy_preds(tds)
        want, _ = jax_validate(jcfg, jds, jmodel, variables, str(tmp_path / f"jax{post}"))
        got, _ = validate(tcfg, tds, model, str(tmp_path / f"port{post}"))
        runs[post] = (got, want, tseen[0], jseen[0])
    got, want, (tp, tb), (jp, jb) = runs[False]
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tp[..., :2], jp[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tp[..., 2], jp[..., 2], atol=1e-5, rtol=1e-4)
    assert got["AP"] == want["AP"]
    argmax = jp[..., :2]
    _, _, (tp, tb), (jp, jb) = runs[True]
    np.testing.assert_allclose(tp[..., 2], jp[..., 2], atol=1e-5, rtol=1e-4)
    assert np.isfinite(tp).all()
    px = jb[:, None, 2:4] * 200 / np.array([12, 16])  # source px per heatmap px (x, y)
    within = np.all(np.abs(jp[..., :2] - argmax) <= px, axis=-1)
    assert within.mean() >= 0.3
    np.testing.assert_allclose(tp[..., :2][within], jp[..., :2][within], atol=1e-3, rtol=0)


def test_eval_pipeline_depth_leaves_the_results(root, tmp_path, seeded):
    """Depth 0 (copy each batch back at once) and 8 (more than the 4 batches:
    the pipeline drains after the loop) give the same results file."""
    *_, model = seeded
    out = {}
    for depth in (0, 8):
        _, tcfg = configs(root, **{"TPU.EVAL_PIPELINE": depth, "TEST.BATCH_SIZE_PER_GPU": 2})
        tds = COCODataset(tcfg, root, "val2017", is_train=False)
        assert len(list(tds.eval_batches(2))) == 4
        out[depth] = validate(tcfg, tds, model, str(tmp_path / str(depth)))
    assert out[0] == out[8]
    assert (tmp_path / "0" / RESULTS).read_bytes() == (tmp_path / "8" / RESULTS).read_bytes()


def test_validate_refuses_what_is_not_ported(root, tmp_path, seeded):
    """A mesh raises. ``DEBUG.DEBUG``, ported since, leaves the results file
    as it is (the heatmaps-out step decoded as the fused one) and dumps the
    first batch's images under the names the JAX ``validate`` gives them,
    each the size of JAX's (``tests/test_torch_debug_vis.py`` holds the
    pixels)."""
    from PIL import Image

    _, tcfg = configs(root)
    tds = COCODataset(tcfg, root, "val2017", is_train=False)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        validate(tcfg, tds, None, str(tmp_path), mesh=object(), device="cpu")
    jmodel, variables, model = seeded
    debug = {"DEBUG.DEBUG": True, "DEBUG.SAVE_BATCH_IMAGES_GT": True,
             "DEBUG.SAVE_HEATMAPS_GT": True, "DEBUG.SAVE_HEATMAPS_PRED": True}
    jcfg, jds, tcfg, tds = datasets(root, **debug)
    *_, tcfg_off, tds_off = datasets(root)
    got = validate(tcfg, tds, model, str(tmp_path / "port"))
    assert got == validate(tcfg_off, tds_off, model, str(tmp_path / "off"))
    assert (tmp_path / "port" / RESULTS).read_bytes() == (tmp_path / "off" / RESULTS).read_bytes()
    jax_validate(jcfg, jds, jmodel, variables, str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax" / "debug").iterdir())
    assert names == ["val_0_gt.jpg", "val_0_hm_gt.jpg", "val_0_hm_pred.jpg"]
    assert sorted(p.name for p in (tmp_path / "port" / "debug").iterdir()) == names
    for name in names:
        assert Image.open(tmp_path / "port" / "debug" / name).size == \
            Image.open(tmp_path / "jax" / "debug" / name).size


def test_fixture_regenerates_and_validates_as_jax(tmp_path):
    """The committed fixture is what its generator writes (annotation bytes,
    cv2's decoded digests, the JAX oracle's ``expected.json``), and the
    port's oracle ``validate`` at the W48 config (256x192, 48x64 maps, blur
    11, B=16) gives the JAX stats on it."""
    fx = torch_fixture.FIXTURE
    torch_fixture.write_fixture(tmp_path)
    assert (tmp_path / torch_fixture.ANN).read_bytes() == (fx / torch_fixture.ANN).read_bytes()
    digests = (fx / "decoded.sha256").read_text()
    assert torch_fixture.decoded_digests(fx) == digests == (tmp_path / "decoded.sha256").read_text()
    expected = json.loads((fx / "expected.json").read_text())
    assert json.loads((tmp_path / "expected.json").read_text()) == expected
    assert sum(expected["results_per_image"].values()) == 134 and expected["stats"]["AP"] > 0.95

    cfg = presets.w48_pure_en6()
    cfg["DATASET"]["ROOT"] = str(fx)
    cfg["TEST"]["BATCH_SIZE_PER_GPU"] = torch_fixture.BATCH
    ds = COCODataset(cfg, str(fx), "val2017", is_train=False)
    got, _ = validate(cfg, ds, None, str(tmp_path / "port"), device="cpu",
                      eval_step_fn=lambda _m, batch: batch["target"])
    for k, v in expected["stats"].items():
        assert abs(got[k] - v) <= 1e-6, k
    results = json.loads((tmp_path / "port" / RESULTS).read_text())
    counts = {}
    for r in results:
        counts[str(r["image_id"])] = counts.get(str(r["image_id"]), 0) + 1
    assert counts == expected["results_per_image"]


def test_train_loop_validates_each_epoch(root, tmp_path):
    """One epoch on the tiny model, validated on the tree: the checkpoint's
    ``perf`` is the AP ``validate`` gives for the trained weights, and
    ``model_best.pth`` is written from it."""
    _, cfg = configs(root)
    cfg["PRINT_FREQ"] = 1
    ds = COCODataset(cfg, root, "val2017", is_train=False)
    raw = synthetic_raw_batch(cfg, [3, 2], np.random.RandomState(5), n_max=3, raw_hw=(96, 128))
    state = train_loop(cfg, str(tmp_path / "train"), lambda epoch: [raw], max_epochs=1,
                       device="cpu", val_dataset=ds)
    payload = load_checkpoint(latest_checkpoint(str(tmp_path / "train")))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(payload["state_dict"])
    name_value, perf = validate(cfg, ds, model, str(tmp_path / "again"))
    assert payload["perf"] == perf == name_value["AP"]
    assert (tmp_path / "train" / RESULTS).exists()
    assert (tmp_path / "train" / "model_best.pth").exists()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
