"""The port's dataset makers (``i2rnet_tpu_torch/data/synthetic.py``) against
the JAX package's (``i2rnet_tpu/data/synthetic.py``).

Each case calls the JAX maker and the port's with the same arguments into two
temporary directories and holds:

* the same file list;
* every JSON file (annotations, detections) byte-equal;
* every raster handed to the encoder bit-equal (``cv2.imwrite`` wrapped on
  the JAX side, ``synthetic._imwrite`` on the port's) and every JPEG file
  byte-equal: Pillow's encoder at the port's settings writes OpenCV's bytes
  here (the same libjpeg-turbo), so no case needs a decoded bound;
* the port's dataset class (``registry.get_dataset_class``) over the port's
  tree gives the db that the JAX class gives over the JAX tree, the image
  paths taken relative to each tree's root.

Besides: the numpy drawing rules against ``cv2.rectangle(..., 2)`` and
``cv2.circle(..., 3, ..., -1)`` at random places, clipped at every border;
the committed ``data/fixtures/synthetic_digests.json`` equal to a fresh
generation by the JAX makers (``tests/torch_fixture.py::synthetic_digests``);
and the port's makers giving those digests, as ``chip_smoke.py`` phase 57
checks them on the card's host.

    python -m pytest tests/test_torch_synthetic.py -q
"""

import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from i2rnet_tpu.data import synthetic as jax_synthetic
from i2rnet_tpu.registry import get_dataset_class as jax_dataset_class
from i2rnet_tpu_torch.data import synthetic
from i2rnet_tpu_torch.registry import get_dataset_class
from test_torch_datasets import both_configs
from test_torch_validate import assert_same

import chip_smoke
import torch_fixture

OCHUMAN_VAL = torch_fixture.TRAIN_SPLITS["OCHuman"]["train"]
#: (maker, its keyword arguments, the dataset whose class reads the tree, split)
CASES = {
    "coco_defaults": ("make_synthetic_coco", {}, "coco", "val2017"),
    "coco_train_wide": ("make_synthetic_coco", {"image_set": "train2017", "max_persons": 9,
                                                "image_hw": (480, 700), "num_images": 2,
                                                "seed": 3}, "coco", "train2017"),
    "crowdpose_trainval": ("make_synthetic_crowdpose", {"image_set": "trainval", "seed": 2},
                           "crowdpose", "trainval"),
    "crowdpose_test": ("make_synthetic_crowdpose", {"image_set": "test"}, "crowdpose", "test"),
    "ochuman_defaults": ("make_synthetic_ochuman", {}, "OCHuman", OCHUMAN_VAL),
    "ochuman_five": ("make_synthetic_ochuman", {"max_persons": 5, "seed": 1}, "OCHuman",
                     OCHUMAN_VAL),
}
#: make_synthetic_detections over a default COCO tree: its defaults, and neither
#: duplicates nor low-score boxes
DETECTIONS = {"defaults": {}, "none_added": {"dup_every": 0, "low_score_every": 0}}


def make_both(tmp_path, maker, kwargs, detections=None):
    """The tree of ``maker(**kwargs)`` from the JAX package and the port, each
    raster captured where it is encoded: ((root, rasters) JAX, the port's)."""
    sides = {}
    for side, module in (("jax", jax_synthetic), ("port", synthetic)):
        root = tmp_path / side
        rasters = {}
        if side == "jax":
            imwrite = cv2.imwrite
            jax_synthetic.cv2.imwrite = lambda p, img, *a: (
                rasters.__setitem__(os.path.relpath(p, root), img.copy()) or imwrite(p, img, *a))
        else:
            imwrite = synthetic._imwrite
            synthetic._imwrite = lambda p, img: (
                rasters.__setitem__(os.path.relpath(p, root), img.copy()) or imwrite(p, img))
        try:
            getattr(module, maker)(str(root), **kwargs)
            if detections is not None:
                module.make_synthetic_detections(str(root), **detections)
        finally:
            if side == "jax":
                jax_synthetic.cv2.imwrite = imwrite
            else:
                synthetic._imwrite = imwrite
        sides[side] = (root, rasters)
    return sides["jax"], sides["port"]


def assert_same_trees(jax_side, port_side):
    (jroot, jrasters), (troot, trasters) = jax_side, port_side
    files = sorted(str(p.relative_to(jroot)) for p in jroot.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(troot)) for p in troot.rglob("*") if p.is_file())
    jpegs = [f for f in files if f.endswith(".jpg")]
    assert jpegs and sorted(jrasters) == sorted(trasters) == jpegs
    for f in jpegs:
        assert trasters[f].dtype == np.uint8 and trasters[f].flags.c_contiguous, f
        np.testing.assert_array_equal(trasters[f], jrasters[f], err_msg=f)
    for f in files:
        assert (troot / f).read_bytes() == (jroot / f).read_bytes(), f
    return files


def relative_db(db, root):
    return [{**rec, "image": os.path.relpath(rec["image"], root)} for rec in db]


def assert_same_dbs(dataset, split, jroot, troot, **changes):
    """The JAX class over the JAX tree and the port's over the port's, each
    with its own tree's ``changes`` (``"SECTION.KEY"`` -> a function of the
    root)."""
    jcfg, _ = both_configs(dataset, jroot, **{k: f(jroot) for k, f in changes.items()})
    _, tcfg = both_configs(dataset, troot, **{k: f(troot) for k, f in changes.items()})
    train = split == jcfg.DATASET.TRAIN_SET
    jds = jax_dataset_class(dataset)(jcfg, str(jroot), split, is_train=train)
    tds = get_dataset_class(dataset)(tcfg, str(troot), split, is_train=train)
    assert len(tds.db) > 0
    assert_same(relative_db(tds.db, troot), relative_db(jds.db, jroot), "db")
    assert all(Path(rec["image"]).is_file() for rec in tds.db)


@pytest.mark.parametrize("case", list(CASES))
def test_makers_match_jax(tmp_path, case):
    maker, kwargs, dataset, split = CASES[case]
    jax_side, port_side = make_both(tmp_path, maker, kwargs)
    files = assert_same_trees(jax_side, port_side)
    assert sum(f.endswith(".json") for f in files) == 1
    assert_same_dbs(dataset, split, jax_side[0], port_side[0])


@pytest.mark.parametrize("case", list(DETECTIONS))
def test_detections_match_jax(tmp_path, case):
    jax_side, port_side = make_both(tmp_path, "make_synthetic_coco", {"max_persons": 4, "seed": 5},
                                    DETECTIONS[case])
    assert_same_trees(jax_side, port_side)
    dets = json.loads((port_side[0] / "annotations" / "person_detections_val2017.json")
                      .read_text())
    n_gt = len(json.loads((port_side[0] / "annotations" / "person_keypoints_val2017.json")
                          .read_text())["annotations"])
    assert (len(dets) > n_gt) == (case == "defaults")
    det = lambda root: str(root / "annotations" / "person_detections_val2017.json")  # noqa: E731
    assert_same_dbs("coco", "val2017", jax_side[0], port_side[0],
                    **{"TEST.USE_GT_BBOX": lambda _root: False, "TEST.IMAGE_THRE": lambda _r: 0.3,
                       "TEST.COCO_BBOX_FILE": det})


@pytest.mark.parametrize("hw", [(240, 320), (37, 53), (480, 700)])
def test_drawing_rules_match_opencv(hw):
    """Rectangles of every size down to 1 x 1 and discs at every distance from
    the borders, inside, across and outside them."""
    h, w = hw
    rng = np.random.RandomState(h)
    for _ in range(400):
        x0, y0 = int(rng.randint(-6, w + 6)), int(rng.randint(-6, h + 6))
        x1, y1 = x0 + int(rng.randint(1, 90)), y0 + int(rng.randint(1, 150))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want, got = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(want, (x0, y0), (x1, y1), color, 2)
        synthetic._rectangle(got, (x0, y0), (x1, y1), color)
        np.testing.assert_array_equal(got, want, err_msg=f"rectangle {(x0, y0, x1, y1)}")
        cx, cy = int(rng.randint(-5, w + 5)), int(rng.randint(-5, h + 5))
        cv2.circle(want, (cx, cy), 3, color, -1)
        synthetic._disc(got, (cx, cy), color)
        np.testing.assert_array_equal(got, want, err_msg=f"disc {(cx, cy)}")


def test_committed_digests_match_a_fresh_jax_generation():
    """``synthetic_digests.json`` as ``tests/torch_fixture.py`` writes it now."""
    assert torch_fixture.SYNTH_DIGESTS.read_text() == torch_fixture.synthetic_digests()


@pytest.mark.parametrize("tree", list(torch_fixture.SYNTH_TREES))
def test_port_makers_give_the_committed_digests(tmp_path, tree):
    """Phase 57's check of each tree (``chip_smoke.make_digested_tree``): the
    JSON files and rasters equal to the JAX makers', and here the JPEGs too."""
    want = json.loads(torch_fixture.SYNTH_DIGESTS.read_text())[tree]
    n, equal, _, _ = chip_smoke.make_digested_tree(want, want, tmp_path / tree)
    assert n == want["args"]["num_images"] == equal
