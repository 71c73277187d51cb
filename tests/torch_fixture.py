"""The fixtures that ``chip_smoke.py`` trains and validates on, and their generator.

``i2rnet_tpu_torch/data/fixtures/coco_synth/`` holds what ``write_fixture``
writes: ``make_synthetic_coco(num_images=32, num_joints=17, max_persons=7,
image_set="val2017", seed=0)`` (two full W48 batches at B=16, up to 7
persons an image), ``decoded.sha256`` (the SHA-256 of each image's bytes as
``cv2.imread`` decodes them, BGR ``[H, W, 3]`` uint8, one ``<hex>  <file>``
line each) and ``expected.json`` (what the JAX ``validate`` gives with the
GT-heatmap oracle at the W48 config: 256x192, heatmaps 48x64, blur 11, flip
test, ``OKS_THRE`` 0.9, B=16: the AP stats and the results per image).

``write_train_fixtures`` adds the training splits of the W48 recipes of
three datasets (``TRAIN_SPLITS``), each written by the JAX package's makers:

* ``coco_synth``: a ``train2017`` split of 16 images of 320x240 and one of
  700x480, wider than the recipe's 640x640 raster (``MAX_IMAGE_HW``), so the
  pre-scale and a flip across it are exercised; ``decoded_train2017.sha256``;
* ``crowdpose_synth``: CrowdPose's ``trainval`` (10 images) and ``test`` (6)
  splits, 14 joints, every ``crowdIndex`` band in the test split;
* ``ochuman_synth``: OCHuman's val-range (10 images, the training split of
  its recipe) and test-range (6) files.

The makers number every split's images from the same id, so a second split
written into the same tree has its image and annotation ids moved by
``ID_OFFSET``. Each training split has ``expected_train.json``: the first
``TRAIN_BATCHES`` batches of epoch 0 that the JAX ``train_batches`` +
``make_raw_batch`` give at the recipe's seeds, ``TRAIN_BATCH`` images a
batch, ``WORKERS`` 0, in the form of
``i2rnet_tpu_torch/data/train_record.py``; the CrowdPose and OCHuman trees
have the oracle's ``expected.json`` of their test split, as ``coco_synth``.

    python tests/torch_fixture.py      # rewrite the committed fixtures

``tests/test_torch_validate.py`` and ``tests/test_torch_datasets.py``
regenerate them into a temporary directory and hold the committed files
equal to that.
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "i2rnet_tpu_torch" / "data" / "fixtures"
FIXTURE = FIXTURES / "coco_synth"
ANN = Path("annotations") / "person_keypoints_val2017.json"
IMAGES = Path("images") / "val2017"
BATCH = 16
#: each dataset's fixture tree, its recipe's splits and the files they take
TRAIN_SPLITS = {
    "coco": {"dir": "coco_synth", "recipe": "coco/interformer_coco_w48_pure_en6.yaml",
             "train": "train2017", "test": "val2017",
             "files": ["annotations/person_keypoints_train2017.json",
                       "decoded_train2017.sha256", "expected_train.json"]},
    "crowdpose": {"dir": "crowdpose_synth",
                  "recipe": "crowdpose/interformer_crowdpose_w48_pure_en6.yaml",
                  "train": "trainval", "test": "test",
                  "files": ["json/crowdpose_trainval.json", "json/crowdpose_test.json",
                            "decoded.sha256", "expected_train.json", "expected.json"]},
    "OCHuman": {"dir": "ochuman_synth", "recipe": "OCHuman/interformer_ochuman_w48_pure_en6.yaml",
                "train": "ochuman_coco_format_val_range_0.00_1.00.json",
                "test": "ochuman_coco_format_test_range_0.00_1.00.json",
                "files": ["ochuman_coco_format_val_range_0.00_1.00.json",
                          "ochuman_coco_format_test_range_0.00_1.00.json",
                          "decoded.sha256", "expected_train.json", "expected.json"]},
}
#: the training batches ``expected_train.json`` holds: images a batch, batches
TRAIN_BATCH, TRAIN_BATCHES = 4, 3
#: the moved ids of a second split written into a tree
ID_OFFSET = 1000


def w48_cfg(root: str):
    """The JAX W48-pure-en6 preset reading the fixture at ``root``, B=16."""
    from i2rnet_tpu.presets import w48_pure_en6

    cfg = w48_pure_en6().clone()
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.TEST.BATCH_SIZE_PER_GPU = BATCH
    return cfg


def decoded_digests(root, images=IMAGES) -> str:
    """``decoded.sha256``: each image under ``images`` as ``cv2.imread`` decodes it."""
    import cv2

    lines = []
    for path in sorted((Path(root) / images).glob("*.jpg")):
        img = cv2.imread(str(path), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        lines.append(f"{hashlib.sha256(img.tobytes()).hexdigest()}  {path.name}\n")
    return "".join(lines)


def oracle(_variables, batch):
    return batch["target"]


def jax_expected(root, cfg=None) -> dict:
    """``expected.json``: the JAX ``validate`` with the GT-heatmap oracle on
    the test split of ``cfg`` (default: the COCO W48 config, val2017)."""
    from i2rnet_tpu.core.validate import validate
    from i2rnet_tpu.registry import get_dataset_class

    cfg = cfg or w48_cfg(str(root))
    test_set = cfg.DATASET.TEST_SET
    ds = get_dataset_class(cfg.DATASET.DATASET)(cfg, str(root), test_set, is_train=False)
    with tempfile.TemporaryDirectory() as out:
        name_value, _ = validate(cfg, ds, model=None, variables=None, output_dir=out,
                                 eval_step_fn=oracle)
        results = json.loads((Path(out) / "results" /
                              f"keypoints_{test_set}_results.json").read_text())
    per_image = {}
    for r in results:
        per_image[str(r["image_id"])] = per_image.get(str(r["image_id"]), 0) + 1
    return {"stats": dict(name_value), "results_per_image": per_image,
            "batch_images": BATCH, "image_size": list(cfg.MODEL.IMAGE_SIZE),
            "heatmap_size": list(cfg.MODEL.HEATMAP_SIZE), "blur_kernel": cfg.TEST.BLUR_KERNEL,
            "oks_thre": cfg.TEST.OKS_THRE}


def write_fixture(root) -> None:
    from i2rnet_tpu.data.synthetic import make_synthetic_coco

    make_synthetic_coco(str(root), num_images=32, num_joints=17, max_persons=7,
                        image_set="val2017", seed=0)
    (Path(root) / "decoded.sha256").write_text(decoded_digests(root))
    (Path(root) / "expected.json").write_text(
        json.dumps(jax_expected(root), indent=1, sort_keys=True) + "\n")


def recipe_cfg(dataset: str, root: str):
    """The JAX W48 preset of ``dataset`` with its recipe's YAML merged over it,
    reading the tree at ``root``, ``TEST.BATCH_SIZE_PER_GPU`` = ``BATCH``."""
    import yaml

    from i2rnet_tpu.presets import w48_pure_en6

    cfg = w48_pure_en6(dataset).clone()
    cfg.merge(yaml.safe_load((REPO / "experiments" / TRAIN_SPLITS[dataset]["recipe"])
                             .read_text()))
    cfg.DATASET.ROOT = root
    cfg.TEST.BATCH_SIZE_PER_GPU = BATCH
    return cfg


def jax_train_records(cfg) -> list:
    """``expected_train.json``'s batches: the JAX trainer's composition
    (``i2rnet_tpu/core/trainer.py:114-130``) at ``WORKERS`` 0 over the first
    ``TRAIN_BATCHES`` batches of epoch 0, ``np.random`` seeded with ``SEED``."""
    import numpy as np

    from i2rnet_tpu.registry import get_dataset_class
    from i2rnet_tpu_torch.data.train_record import batch_record

    ds = get_dataset_class(cfg.DATASET.DATASET)(cfg, cfg.DATASET.ROOT, cfg.DATASET.TRAIN_SET,
                                                is_train=True)
    epoch = 0
    np.random.seed(cfg.SEED)
    records = []
    for idx, (items, nb) in enumerate(ds.train_batches(
            TRAIN_BATCH, np.random.RandomState(cfg.SEED + 1000 + epoch))):
        rng = np.random.RandomState((cfg.SEED + 1) * 100003 + epoch * 10007 + idx)
        raw, _ = ds.make_raw_batch(items, nb, rng)
        records.append(batch_record(items, nb, raw))
        if len(records) == TRAIN_BATCHES:
            break
    return records


def _move_split(src: Path, dst: Path, ann: str, images: str, name, offset: int) -> None:
    """Copy the split of ``src`` (annotation file ``ann``, images under
    ``images``) into ``dst``, its image ids moved by ``offset`` (``name(id)``
    the image's file name) and its annotation ids after ``dst``'s."""
    d = json.loads((src / ann).read_text())
    (dst / images).mkdir(parents=True, exist_ok=True)
    old = {im["id"]: im["file_name"] for im in d["images"]}
    for im in d["images"]:
        im["id"] += offset
        im["file_name"] = name(im["id"])
        shutil.copyfile(src / images / old[im["id"] - offset], dst / images / im["file_name"])
    for a in d["annotations"]:
        a["image_id"] += offset
    target = dst / ann
    if target.exists():  # add the split's images to the annotations there
        have = json.loads(target.read_text())
        first = max(a["id"] for a in have["annotations"])
        for a in d["annotations"]:
            a["id"] += first
        have["images"] += d["images"]
        have["annotations"] += d["annotations"]
        d = have
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target, "w") as f:
        json.dump(d, f)


def _write_expected(root: Path, dataset: str, test: bool) -> None:
    cfg = recipe_cfg(dataset, str(root))
    records = {"seed": cfg.SEED, "epoch": 0, "np_random_seed": cfg.SEED,
               "batch_images": TRAIN_BATCH, "batches": jax_train_records(cfg)}
    (root / "expected_train.json").write_text(json.dumps(records, sort_keys=True) + "\n")
    if test:
        (root / "expected.json").write_text(
            json.dumps(jax_expected(root, cfg), indent=1, sort_keys=True) + "\n")


def write_train_fixtures(fixtures) -> None:
    """The training splits of ``TRAIN_SPLITS`` under ``fixtures`` (the COCO
    one beside ``write_fixture``'s val2017 in ``coco_synth``)."""
    from i2rnet_tpu.data.synthetic import (make_synthetic_coco, make_synthetic_crowdpose,
                                           make_synthetic_ochuman)

    fixtures = Path(fixtures)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        coco = fixtures / TRAIN_SPLITS["coco"]["dir"]
        make_synthetic_coco(str(coco), num_images=16, num_joints=17, max_persons=9,
                            image_set="train2017", seed=2)
        make_synthetic_coco(str(tmp / "large"), num_images=1, image_hw=(480, 700),
                            num_joints=17, max_persons=9, image_set="train2017", seed=3)
        _move_split(tmp / "large", coco, "annotations/person_keypoints_train2017.json",
                    "images/train2017", lambda i: f"{i:012d}.jpg", 16)
        (coco / "decoded_train2017.sha256").write_text(
            decoded_digests(coco, Path("images") / "train2017"))
        _write_expected(coco, "coco", test=False)

        crowd = fixtures / TRAIN_SPLITS["crowdpose"]["dir"]
        make_synthetic_crowdpose(str(crowd), num_images=10, max_persons=7, image_set="trainval",
                                 seed=2)
        make_synthetic_crowdpose(str(tmp / "crowd"), num_images=6, max_persons=7,
                                 image_set="test", seed=3)
        _move_split(tmp / "crowd", crowd, "json/crowdpose_test.json", "images",
                    lambda i: f"{i}.jpg", ID_OFFSET)

        och = fixtures / TRAIN_SPLITS["OCHuman"]["dir"]
        make_synthetic_ochuman(str(och), num_images=10, max_persons=5,
                               ann_name=TRAIN_SPLITS["OCHuman"]["train"], seed=2)
        make_synthetic_ochuman(str(tmp / "och"), num_images=6, max_persons=5,
                               ann_name=TRAIN_SPLITS["OCHuman"]["test"], seed=3)
        _move_split(tmp / "och", och, TRAIN_SPLITS["OCHuman"]["test"], "images",
                    lambda i: f"{i:06d}.jpg", ID_OFFSET)
    for tree, dataset in ((crowd, "crowdpose"), (och, "OCHuman")):
        (tree / "decoded.sha256").write_text(decoded_digests(tree, Path("images")))
        _write_expected(tree, dataset, test=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    write_fixture(FIXTURE)
    write_train_fixtures(FIXTURES)
    print(f"wrote {FIXTURES}")
