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

``write_mpii`` writes ``mpii_synth`` (4 single-person images, the MPII
annotation JSON and ``gt_valid.mat``, and the JAX oracle's PCKh table in
``expected.json``), and ``expected_recipes`` the port config of each of the
ten recipes under ``experiments/`` as the JAX reader gives it
(``i2rnet_tpu_torch/config/expected_recipes.json``), which ``chip_smoke.py``
holds the port's YAML reader to on a machine without JAX or PyYAML.

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
#: the MPII fixture (``write_mpii``) and its images a batch
MPII = FIXTURES / "mpii_synth"
MPII_BATCH = 4
#: the port configs of the recipes (``expected_recipes``)
RECIPES_JSON = REPO / "i2rnet_tpu_torch" / "config" / "expected_recipes.json"


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


#: the trees whose ``expected_detail.json`` holds the JAX ``TEST.DETAIL_EVAL``
#: report, and the dataset each is read as
DETAIL_TREES = {"coco_synth": "coco", "ochuman_synth": "OCHuman"}


def detail_cfg(tree: str):
    """The JAX config whose oracle ``validate`` gives ``tree``'s
    ``expected_detail.json``: as ``expected.json``'s, ``TEST.DETAIL_EVAL`` on."""
    root = str(FIXTURES / tree)
    dataset = DETAIL_TREES[tree]
    cfg = (w48_cfg(root) if dataset == "coco" else recipe_cfg(dataset, root)).clone()
    cfg.TEST.DETAIL_EVAL = True
    return cfg


def jax_expected_detail(tree: str) -> str:
    """``expected_detail.json``: the JAX oracle ``validate``'s ``name_value``
    with ``TEST.DETAIL_EVAL`` on (its stats and AP per crowd level), and the
    ``res_eval.txt`` it writes."""
    from i2rnet_tpu.core.validate import validate
    from i2rnet_tpu.registry import get_dataset_class

    cfg = detail_cfg(tree)
    test_set = cfg.DATASET.TEST_SET
    root = str(FIXTURES / tree)
    ds = get_dataset_class(cfg.DATASET.DATASET)(cfg, root, test_set, is_train=False)
    with tempfile.TemporaryDirectory() as out:
        name_value, _ = validate(cfg, ds, model=None, variables=None, output_dir=out,
                                 eval_step_fn=oracle)
        report = (Path(out) / "results" / "res_eval.txt").read_text()
    return json.dumps({"name_value": dict(name_value), "res_eval_levels":
                       [line for line in report.splitlines() if line.startswith("Class ")]},
                      indent=1, sort_keys=True) + "\n"


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


def mpii_cfg(root: str):
    """The JAX W48 preset on MPII (16 joints) reading ``root``'s ``valid``
    split, ``MPII_BATCH`` images a batch."""
    from i2rnet_tpu.presets import w48_pure_en6

    cfg = w48_pure_en6().clone()
    cfg.MODEL.NUM_JOINTS = 16
    cfg.DATASET.DATASET = "mpii"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "valid"
    cfg.TEST.BATCH_SIZE_PER_GPU = MPII_BATCH
    return cfg


def write_mpii(root) -> None:
    """``mpii_synth``: ``tests/test_mpii.py::_make_mpii``'s tree (seed 0;
    JPEGs, ``annot/valid.json``, ``annot/gt_valid.mat``), ``decoded.sha256``
    and ``expected.json``: the JAX ``validate``'s PCKh table with the
    GT-heatmap oracle at ``mpii_cfg``."""
    import numpy as np

    from i2rnet_tpu.core.validate import validate
    from i2rnet_tpu.registry import get_dataset_class
    from test_mpii import _make_mpii

    root = Path(root)
    _make_mpii(str(root), np.random.RandomState(0))
    (root / "decoded.sha256").write_text(decoded_digests(root, Path("images")))
    cfg = mpii_cfg(str(root))
    ds = get_dataset_class("mpii")(cfg, str(root), "valid", is_train=False)
    with tempfile.TemporaryDirectory() as out:
        name_value, _ = validate(cfg, ds, model=None, variables=None, output_dir=out,
                                 eval_step_fn=oracle)
    expected = {"stats": {k: float(v) for k, v in name_value.items()},
                "batch_images": MPII_BATCH, "image_size": list(cfg.MODEL.IMAGE_SIZE),
                "heatmap_size": list(cfg.MODEL.HEATMAP_SIZE),
                "blur_kernel": cfg.TEST.BLUR_KERNEL}
    (root / "expected.json").write_text(json.dumps(expected, indent=1, sort_keys=True) + "\n")


#: the keys of a JAX config that a port config carries, section by section,
#: written out here apart from ``config/config.py``'s lists
JAX_PORT_KEYS = {
    "MODEL": ("NAME", "NUM_JOINTS", "IMAGE_SIZE", "HEATMAP_SIZE", "TRANS_SIZE", "DIM_MODEL",
              "DIM_FEEDFORWARD", "N_HEAD", "ENCODER_LAYERS", "USE_MULTI_POS",
              "MULTI_POS_EMBEDDING", "SIGMA", "LOSS_WEIGHTS", "SINGLEFORMER", "SINGLEFORMER_FIX",
              "INTER_SUPERVISION", "ENCODER_MULTI_LAYERS", "UPSAMPLE_TYPE", "ATTENTION_TYPE",
              "DOMAIN_TRANS", "POS_EMBEDDING", "PE_ONLY_AT_BEGIN", "HRNET_RES_LAYER",
              "MULTI_POS_EMBEDDING_DIM", "SINGLE_MODEL", "PRETRAINED", "INIT_WEIGHTS",
              "BACKBONE_FIX", "END2END", "ENCODER_SINGLE_LAYERS", "ENCODER_MUTI_LAYERS",
              "SINGLE_POS_EMBEDDING"),
    "DATASET": ("DATASET", "ROOT", "TRAIN_SET", "TEST_SET", "PATCH_MODE", "COLOR_RGB",
                "USE_COCOMINI", "MAX_PATCH", "SELECT_DATA", "SCALE_FACTOR", "ROT_FACTOR", "FLIP",
                "PROB_HALF_BODY", "NUM_JOINTS_HALF_BODY"),
    "TEST": ("FLIP_TEST", "BLUR_KERNEL", "POST_PROCESS", "BATCH_SIZE_PER_GPU", "USE_GT_BBOX",
             "COCO_BBOX_FILE", "IMAGE_THRE", "IN_VIS_THRE", "OKS_THRE", "SOFT_NMS", "DETAIL_EVAL",
             "MODEL_FILE"),
    "TRAIN": ("BATCH_SIZE_PER_GPU", "BEGIN_EPOCH", "END_EPOCH", "LR", "LR_END", "OPTIMIZER",
              "MOMENTUM", "WD", "NESTEROV"),
    "LOSS": ("USE_OHKM", "TOPK", "USE_TARGET_WEIGHT", "USE_DIFFERENT_JOINTS_WEIGHT"),
}
JAX_TOP_KEYS = ("SEED", "AUTO_RESUME", "PRINT_FREQ", "WORKERS", "OUTPUT_DIR", "LOG_DIR",
                "DATA_DIR")


def _plain(v):
    if hasattr(v, "to_dict"):
        v = v.to_dict()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def jax_port_config(cfg) -> dict:
    """The port config of a JAX ``Config``, read by attribute access: the
    reference that ``config.to_port`` is held to (they share no code). The
    ``TPU`` knobs are read as the JAX package defines them
    (``i2rnet_tpu/config/config.py``); ``MAX_IMAGE_HW``, which it leaves
    out, with the default its dataset reads (``data/dataset.py``)."""
    tpu = cfg.TPU
    return {
        "MODEL": {**{k: _plain(getattr(cfg.MODEL, k)) for k in JAX_PORT_KEYS["MODEL"]},
                  "EXTRA": _plain(cfg.MODEL.EXTRA)},
        **{sec: {k: _plain(getattr(getattr(cfg, sec), k)) for k in JAX_PORT_KEYS[sec]}
           for sec in ("DATASET", "TEST")},
        "DEVICE": {"COMPUTE_DTYPE": tpu.COMPUTE_DTYPE,
                   "USE_KERNELS": bool(tpu.USE_PALLAS_ATTENTION),
                   "FLASH_TRAIN_ATTENTION": bool(tpu.FLASH_TRAIN_ATTENTION),
                   "FUSED_FFN_TRAIN": bool(tpu.FUSED_FFN_TRAIN),
                   "FUSED_BLOCK_EVAL": bool(tpu.FUSED_BLOCK_EVAL),
                   "FUSED_BLOCK_EVAL_ONEPASS": bool(tpu.FUSED_BLOCK_EVAL_ONEPASS),
                   "FUSED_MLP_EVAL": bool(tpu.FUSED_MLP_EVAL),
                   "FUSED_BLOCK_TRAIN": bool(tpu.FUSED_BLOCK_TRAIN),
                   "FROZEN_STAGE_EVAL_MODE": bool(tpu.FROZEN_STAGE_EVAL_MODE),
                   "REMAT": _plain(tpu.REMAT),
                   "MAX_IMAGE_HW": _plain(list(tpu.get("MAX_IMAGE_HW", (640, 640)))),
                   "EVAL_PIPELINE": int(tpu.EVAL_PIPELINE)},
        **{sec: {k: _plain(getattr(getattr(cfg, sec), k)) for k in JAX_PORT_KEYS[sec]}
           for sec in ("TRAIN", "LOSS")},
        "DEBUG": {k: bool(getattr(cfg.DEBUG, k)) for k in
                  ("DEBUG", "SAVE_BATCH_IMAGES_GT", "SAVE_BATCH_IMAGES_PRED", "SAVE_HEATMAPS_GT",
                   "SAVE_HEATMAPS_PRED")},
        **{k: _plain(getattr(cfg, k)) for k in JAX_TOP_KEYS},
    }


def expected_recipes() -> str:
    """``expected_recipes.json``: the port config of every recipe under
    ``experiments/`` as the JAX reader gives it (``jax_port_config`` of its
    ``load_config``), keyed by the path under ``experiments/``."""
    from i2rnet_tpu.config import load_config

    out = {}
    for path in sorted((REPO / "experiments").glob("*/*.yaml")):
        rel = path.relative_to(REPO)
        out[str(rel.relative_to("experiments"))] = jax_port_config(load_config(str(rel)))
    return json.dumps(out, indent=1, sort_keys=True) + "\n"


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    os.chdir(REPO)
    write_fixture(FIXTURE)
    write_train_fixtures(FIXTURES)
    shutil.rmtree(MPII, ignore_errors=True)
    write_mpii(MPII)
    RECIPES_JSON.write_text(expected_recipes())
    for tree in DETAIL_TREES:
        (FIXTURES / tree / "expected_detail.json").write_text(jax_expected_detail(tree))
    print(f"wrote {FIXTURES} and {RECIPES_JSON}")
