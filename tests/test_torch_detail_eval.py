"""``TEST.DETAIL_EVAL``'s crowd-stratified report against the JAX package's.

``utils/detail_eval.py::detail_evaluate`` on the same GT and detections as
``i2rnet_tpu/utils/detail_eval.py``: the same levels and AP per level, the
same ``res_eval.txt`` text (every stat line and person-count histogram), for
the default bands ``(1, 2, 6, 10)`` and OCHuman's ``(1, 2)``, on images of
1 to 12 persons with misses, false positives, crowds and persons without
keypoints. Every comparison is exact: the port copies the numpy arithmetic.
Through ``COCODataset.evaluate`` the same holds for COCO and OCHuman
(``tests/test_torch_coco_eval.py``), and through ``validate`` with the
GT-heatmap oracle on the CrowdPose and OCHuman fixtures, whose AP does not
move with the report on.
"""

import json

import numpy as np
import pytest

import torch_fixture
from i2rnet_tpu.core.validate import validate as jax_validate
from i2rnet_tpu.registry import get_dataset_class as jax_dataset_class
from i2rnet_tpu.utils import detail_eval as jdetail
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.data.ochuman import OCHumanDataset
from i2rnet_tpu_torch.registry import get_dataset_class
from i2rnet_tpu_torch.utils import detail_eval
from test_torch_coco_eval import random_person
from test_torch_datasets import both_configs

#: persons per image: every default band is populated, the open one twice
COUNTS = [1, 1, 1, 2, 3, 5, 6, 7, 9, 10, 12, 0]


def crowd_gt_dt(seed, k=17):
    rng = np.random.RandomState(seed)
    gt, dt = {}, {}
    for img, n in enumerate(COUNTS, start=1):
        gl = [random_person(rng, k, crowd=rng.rand() < 0.05, invisible=rng.rand() < 0.1)
              for _ in range(n)]
        for i, g in enumerate(gl):
            g["id"] = img * 100 + i
        dl = []
        for g in gl:
            if rng.rand() < 0.85:
                kp = np.asarray(g["keypoints"]).reshape(k, 3).copy()
                kp[:, :2] += rng.randn(k, 2) * rng.choice([0.5, 3.0, 10.0])
                kp[:, 2] = rng.rand(k)
                dl.append({"keypoints": kp.reshape(-1).tolist(), "score": float(rng.rand())})
        if rng.rand() < 0.5:
            dl.append({"keypoints": random_person(rng, k)["keypoints"], "score": 0.3})
        gt[img] = gl
        if dl:
            dt[img] = dl
    return gt, dt


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bands", [(1, 2, 6, 10), (1, 2)], ids=["default", "ochuman"])
def test_detail_evaluate_matches_jax(bands, seed, tmp_path):
    gt, dt = crowd_gt_dt(seed)
    all_stats = [("AP", 0.5), ("Ap .5", 0.75)]
    got = detail_eval.detail_evaluate(gt, dt, cluster_mode=bands,
                                      report_path=str(tmp_path / "port" / "res_eval.txt"),
                                      all_stats=all_stats)
    want = jdetail.detail_evaluate(gt, dt, cluster_mode=bands,
                                   report_path=str(tmp_path / "jax" / "res_eval.txt"),
                                   all_stats=all_stats)
    assert list(got.items()) == list(want.items())
    assert len(got) == len(bands)
    text = (tmp_path / "port" / "res_eval.txt").read_text()
    assert text == (tmp_path / "jax" / "res_eval.txt").read_text()
    assert text.count("Class c") == len(bands) and "('AP', 0.5)" in text


@pytest.mark.parametrize("bands", [(1, 2, 6, 10), (1, 2), (2, 4), (3,)])
def test_cluster_bands_match_jax(bands):
    assert detail_eval.cluster_bands(bands) == jdetail.cluster_bands(bands)


def test_detail_evaluate_skips_empty_levels(tmp_path):
    """Levels that hold no image are left out of the result and the report,
    as in JAX; no report is written without ``report_path``."""
    gt, dt = crowd_gt_dt(2)
    few = {i: gt[i] for i in (1, 2, 4)}  # 1, 1 and 2 persons
    got = detail_eval.detail_evaluate(few, dt, report_path=str(tmp_path / "r.txt"))
    assert list(got) == ["AP(c1:n=1)", "AP(c2:n=2-5)"]
    assert got == jdetail.detail_evaluate(few, dt)
    assert (tmp_path / "r.txt").read_text().count("Class c") == 2


def test_the_datasets_carry_the_reference_bands():
    assert COCODataset.detail_cluster_mode == (1, 2, 6, 10)
    assert OCHumanDataset.detail_cluster_mode == (1, 2)


@pytest.mark.parametrize("dataset,tree", [("crowdpose", "crowdpose_synth"),
                                          ("OCHuman", "ochuman_synth")])
def test_validate_with_detail_eval_matches_jax(dataset, tree, tmp_path):
    root = torch_fixture.FIXTURES / tree
    jcfg, tcfg = both_configs(dataset, root, **{"TEST.DETAIL_EVAL": True})
    test_set = jcfg.DATASET.TEST_SET
    jds = jax_dataset_class(dataset)(jcfg, str(root), test_set, is_train=False)
    tds = get_dataset_class(dataset)(tcfg, str(root), test_set, is_train=False)
    want, _ = jax_validate(jcfg, jds, None, None, str(tmp_path / "jax"),
                           eval_step_fn=lambda _v, batch: batch["target"])
    got, perf = validate(tcfg, tds, None, str(tmp_path / "port"), device="cpu",
                         eval_step_fn=lambda _m, batch: batch["target"])
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    levels = [k for k in got if k.startswith("AP(c")]
    # the CrowdPose split holds 1-4 persons an image, OCHuman's only crowds
    assert levels == (["AP(c2:n>=2)"] if dataset == "OCHuman" else levels) and levels
    expected = json.loads((root / "expected.json").read_text())
    for k, v in expected["stats"].items():  # AP as with the report off
        assert abs(got[k] - v) <= 1e-6, k
    assert perf == got["AP"]
    report = "results/res_eval.txt"
    port, ref = (tmp_path / "port" / report).read_text(), (tmp_path / "jax" / report).read_text()
    assert port.splitlines()[:3] == ref.splitlines()[:3]
    assert port.count("Class c") == ref.count("Class c") == len(levels)


@pytest.mark.parametrize("tree", list(torch_fixture.DETAIL_TREES))
def test_detail_fixture_regenerates_and_validates_as_jax(tree, tmp_path):
    """The committed ``expected_detail.json`` (what ``chip_smoke.py`` holds the
    card's report to) is what the JAX oracle ``validate`` gives, and the
    port's oracle ``validate`` gives its levels and stats."""
    path = torch_fixture.FIXTURES / tree / "expected_detail.json"
    assert path.read_text() == torch_fixture.jax_expected_detail(tree)
    want = json.loads(path.read_text())
    jcfg = torch_fixture.detail_cfg(tree)
    tcfg = presets.from_config(jcfg)
    d = tcfg["DATASET"]
    tds = get_dataset_class(d["DATASET"])(tcfg, d["ROOT"], d["TEST_SET"], is_train=False)
    got, _ = validate(tcfg, tds, None, str(tmp_path), device="cpu",
                      eval_step_fn=lambda _m, batch: batch["target"])
    assert sorted(got) == sorted(want["name_value"])
    for k, v in want["name_value"].items():
        assert abs(got[k] - v) <= 1e-6, k
    report = (tmp_path / "results" / "res_eval.txt").read_text()
    assert [x for x in report.splitlines() if x.startswith("Class ")] == want["res_eval_levels"]
