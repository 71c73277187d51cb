"""The port's host evaluation against the JAX package's, on the same inputs.

* ``CocoJson``: every index it builds from a random annotation file.
* ``KeypointEval``: the ten COCO and the nine CrowdPose stats on random GT
  and detections with crowds, zero-visibility persons, persons without
  keypoints and tied scores.
* ``oks_nms`` and ``soft_oks_nms``: the kept indices, with duplicated
  persons and tied scores, for 17, 14 and 5 joints and with ``in_vis_thre``.
* ``COCODataset.evaluate``: the same ``preds``, ``all_boxes`` and
  ``image_ids`` give byte-equal results JSON files and equal ``name_value``,
  with OKS-NMS and with soft OKS-NMS.

Every comparison is exact: the port copies the numpy arithmetic.
"""

import json

import numpy as np
import pytest

from i2rnet_tpu.data.coco import COCODataset as JaxCOCO
from i2rnet_tpu.data.coco_format import CocoJson as JaxCocoJson
from i2rnet_tpu.data.synthetic import make_synthetic_coco
from i2rnet_tpu.ops import cocoeval as jeval
from i2rnet_tpu.ops import nms as jnms
from i2rnet_tpu.presets import tiny_test_config
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.data.coco_format import CocoJson
from i2rnet_tpu_torch.ops import cocoeval as teval
from i2rnet_tpu_torch.ops import nms as tnms


def random_person(rng, k, w=320, h=240, crowd=False, invisible=False):
    bw, bh = rng.uniform(20, 120), rng.uniform(40, 160)
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    kp = np.zeros((k, 3))
    kp[:, 0] = rng.uniform(x0, x0 + bw, k).round(1)
    kp[:, 1] = rng.uniform(y0, y0 + bh, k).round(1)
    kp[:, 2] = 0 if invisible else rng.choice([0, 1, 2], k, p=[0.2, 0.2, 0.6])
    return {"keypoints": kp.reshape(-1).tolist(), "bbox": [x0, y0, bw, bh],
            "area": float(bw * bh * rng.uniform(0.5, 1.0)), "iscrowd": int(crowd),
            "num_keypoints": int(np.count_nonzero(kp[:, 2]))}


def random_gt_dt(rng, k, n_images=12):
    """GT per image (some crowds, some zero-visibility persons) and detections
    near them, with misses, false positives and tied scores."""
    gt, dt = {}, {}
    for img in range(1, n_images + 1):
        gl = [random_person(rng, k, crowd=rng.rand() < 0.1, invisible=rng.rand() < 0.15)
              for _ in range(rng.randint(0, 6))]
        for i, g in enumerate(gl):
            g["id"] = img * 100 + i
        dl = []
        for g in gl:
            if rng.rand() < 0.8:
                kp = np.asarray(g["keypoints"]).reshape(k, 3).copy()
                kp[:, :2] += rng.randn(k, 2) * rng.choice([0.5, 3.0, 15.0])
                kp[:, 2] = rng.rand(k)
                dl.append({"keypoints": kp.reshape(-1).tolist(),
                           "score": float(rng.choice([0.9, 0.5, rng.rand()]))})
        for _ in range(rng.randint(0, 3)):
            p = random_person(rng, k)
            dl.append({"keypoints": p["keypoints"], "score": float(rng.choice([0.9, rng.rand()]))})
        if gl or rng.rand() < 0.5:
            gt[img] = gl
        if dl:
            dt[img] = dl
    return gt, dt


def test_coco_json_matches_jax(tmp_path, rng):
    gt, _ = random_gt_dt(rng, 17)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "height": 240, "width": 320}
              for i in range(1, 14)]
    anns = [{**a, "image_id": img, "category_id": int(rng.choice([1, 1, 1, 2]))}
            for img, gl in gt.items() for a in gl]
    path = tmp_path / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": 2, "name": "dog"}, {"id": 1, "name": "person"}]}))
    got, want = CocoJson(str(path)), JaxCocoJson(str(path))
    assert got.dataset == want.dataset
    assert (got.imgs, got.anns, got.cats) == (want.imgs, want.anns, want.cats)
    assert dict(got.img_to_anns) == dict(want.img_to_anns)
    assert got.get_img_ids() == want.get_img_ids()
    assert got.person_cat_id() == want.person_cat_id() == 1
    for img in got.get_img_ids():
        assert got.load_img(img) == want.load_img(img)
        for crowd in (False, True, None):
            assert got.get_anns(img, iscrowd=crowd) == want.get_anns(img, iscrowd=crowd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keypoint_eval_matches_jax(seed):
    rng = np.random.RandomState(seed)
    gt, dt = random_gt_dt(rng, 17)
    got = teval.KeypointEval(gt, dt, num_joints=17).summarize_coco()
    want = jeval.KeypointEval(gt, dt, num_joints=17).summarize_coco()
    assert got == want
    assert 0.0 < dict(got)["AP"] < 1.0
    gt, dt = random_gt_dt(rng, 14)
    crowd = {i: float(rng.choice([0.05, 0.4, 0.9, 1.0])) for i in range(1, 13)}
    got = teval.KeypointEval(gt, dt, num_joints=14, crowd_index=crowd).summarize_crowdpose()
    want = jeval.KeypointEval(gt, dt, num_joints=14, crowd_index=crowd).summarize_crowdpose()
    assert got == want
    oks = [(teval.compute_oks(gt[i], dt[i], tnms.sigmas_for(14)),
            jeval.compute_oks(gt[i], dt[i], jnms.sigmas_for(14))) for i in dt if gt.get(i)]
    for a, b in oks:
        np.testing.assert_array_equal(a, b)


def kpts_db(rng, k, n):
    """Candidates of one image: jittered copies of a few persons (exact
    duplicates among them), tied scores."""
    base = [np.asarray(random_person(rng, k)["keypoints"]).reshape(k, 3) for _ in range(3)]
    db = []
    for i in range(n):
        kp = base[i % 3].copy()
        if i >= 3 and i % 4:
            kp[:, :2] += rng.randn(k, 2) * rng.choice([0.3, 2.0, 8.0])
        kp[:, 2] = rng.rand(k)
        db.append({"keypoints": kp, "area": float(rng.uniform(2000, 9000)),
                   "score": float(rng.choice([0.8, 0.8, rng.rand()]))})
    return db


@pytest.mark.parametrize("k", [17, 14, 5])
def test_oks_nms_matches_jax(k):
    rng = np.random.RandomState(k)
    for trial in range(40):
        db = kpts_db(rng, k, int(rng.randint(1, 12)))
        thr = float(rng.choice([0.3, 0.5, 0.9]))
        vis = [None, 0.2][trial % 2]
        got = tnms.oks_nms(db, thr, in_vis_thre=vis, num_joints=k)
        assert got == jnms.oks_nms(db, thr, in_vis_thre=vis, num_joints=k)
        kpts, areas, scores = jnms._db_to_arrays(db)
        iou = jnms.np_oks_iou_matrix(kpts, areas, jnms.sigmas_for(k), in_vis_thre=vis)
        assert got == jnms._np_greedy_from_iou(iou, scores, thr)
        got = tnms.soft_oks_nms(db, thr, in_vis_thre=vis, num_joints=k, max_dets=8)
        assert got == jnms.soft_oks_nms(db, thr, in_vis_thre=vis, num_joints=k, max_dets=8)
        assert got == jnms._np_soft_from_iou(iou, scores, thr, 8)
    assert tnms.oks_nms([], 0.9) == [] and tnms.soft_oks_nms([], 0.9) == []


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("coco5")), num_images=8, num_joints=5,
                               max_persons=4, image_set="val2017", seed=3)


def coco_cfgs(root, **test):
    """The JAX tiny config reading the tree at ``root``, and the port's
    (``from_config``)."""
    cfg = tiny_test_config(5).clone()
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.TPU.MAX_IMAGE_HW = (256, 320)
    for k, v in test.items():
        setattr(cfg.TEST, k, v)
    return cfg, presets.from_config(cfg)


@pytest.mark.parametrize("soft", [False, True], ids=["oks_nms", "soft_nms"])
def test_evaluate_matches_jax(synth_root, tmp_path, soft):
    """The same predictions (GT with jitter and duplicates, so NMS drops
    some) through both ``evaluate``s: byte-equal results files."""
    jcfg, tcfg = coco_cfgs(synth_root, SOFT_NMS=soft, OKS_THRE=0.6)
    jds = JaxCOCO(jcfg, synth_root, "val2017", is_train=False)
    tds = COCODataset(tcfg, synth_root, "val2017", is_train=False)
    rng = np.random.RandomState(5)
    preds, boxes, ids = [], [], []
    for rec in jds.db:
        for a in rec["annos"] + rec["annos"][:1]:
            kp = np.concatenate([a["joints_3d"][:, :2] + rng.randn(5, 2) * 2.0,
                                 rng.rand(5, 1)], axis=1)
            preds.append(kp)
            boxes.append([*a["center"], *a["scale"], float(np.prod(a["scale"] * 200)),
                          rng.choice([1.0, 0.9])])
            ids.append(rec["image_id"])
    preds, boxes = np.asarray(preds, np.float32), np.asarray(boxes, np.float32)
    got = tds.evaluate(tcfg, preds, str(tmp_path / "port"), boxes, ids)
    want = jds.evaluate(jcfg, preds, str(tmp_path / "jax"), boxes, ids)
    assert got[0] == want[0] and got[1] == want[1]
    name = "results/keypoints_val2017_results.json"
    port_file = (tmp_path / "port" / name).read_bytes()
    assert port_file == (tmp_path / "jax" / name).read_bytes()
    if not soft:  # OKS-NMS dropped the duplicates; soft NMS rescored them
        assert len(json.loads(port_file)) < len(preds)
    assert 0.0 < got[1] <= 1.0


def test_unported_evaluation_options_raise(synth_root, tmp_path):
    """``TEST.DETAIL_EVAL``, ported since, evaluates as JAX's: the same
    ``name_value`` with its crowd levels, and the same ``res_eval.txt``
    (``tests/test_torch_detail_eval.py`` holds the report itself). A training
    dataset, ported since, reads the GT boxes even where evaluation would
    take a detector's (as the JAX one does): its db equals JAX's."""
    jcfg, tcfg = coco_cfgs(synth_root, DETAIL_EVAL=True)
    jds = JaxCOCO(jcfg, synth_root, "val2017", is_train=False)
    tds = COCODataset(tcfg, synth_root, "val2017", is_train=False)
    rng = np.random.RandomState(6)
    preds, boxes, ids = [], [], []
    for rec in jds.db:
        for a in rec["annos"]:
            preds.append(np.concatenate([a["joints_3d"][:, :2] + rng.randn(5, 2) * 2.0,
                                         rng.rand(5, 1)], axis=1))
            boxes.append([*a["center"], *a["scale"], float(np.prod(a["scale"] * 200)), 1.0])
            ids.append(rec["image_id"])
    preds, boxes = np.asarray(preds, np.float32), np.asarray(boxes, np.float32)
    got = tds.evaluate(tcfg, preds, str(tmp_path / "port"), boxes, ids)
    want = jds.evaluate(jcfg, preds, str(tmp_path / "jax"), boxes, ids)
    assert got == want and any(k.startswith("AP(c") for k in got[0])
    report = "results/res_eval.txt"
    assert (tmp_path / "port" / report).read_text() == (tmp_path / "jax" / report).read_text()
    jcfg, tcfg = coco_cfgs(synth_root, USE_GT_BBOX=False, COCO_BBOX_FILE="missing.json")
    train = COCODataset(tcfg, synth_root, "val2017", is_train=True)
    want = JaxCOCO(jcfg, synth_root, "val2017", is_train=True).db
    assert len(train.db) == len(want) > 0
    for got, ref in zip(train.db, want):
        assert got["image"] == ref["image"] and len(got["annos"]) == len(ref["annos"])
        for a, b in zip(got["annos"], ref["annos"]):
            np.testing.assert_array_equal(a["joints_3d"], b["joints_3d"])
            assert a["box"] == b["box"]
