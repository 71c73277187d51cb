"""The COCO-format fixture that ``chip_smoke.py`` validates on, and its generator.

``i2rnet_tpu_torch/data/fixtures/coco_synth/`` holds what ``write_fixture``
writes: ``make_synthetic_coco(num_images=32, num_joints=17, max_persons=7,
image_set="val2017", seed=0)`` (two full W48 batches at B=16, up to 7
persons an image), ``decoded.sha256`` (the SHA-256 of each image's bytes as
``cv2.imread`` decodes them, BGR ``[H, W, 3]`` uint8, one ``<hex>  <file>``
line each) and ``expected.json`` (what the JAX ``validate`` gives with the
GT-heatmap oracle at the W48 config: 256x192, heatmaps 48x64, blur 11, flip
test, ``OKS_THRE`` 0.9, B=16: the AP stats and the results per image).

    python tests/torch_fixture.py      # rewrite the committed fixture

``tests/test_torch_validate.py`` regenerates it into a temporary directory
and holds the committed files equal to that.
"""

import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "i2rnet_tpu_torch" / "data" / "fixtures" / "coco_synth"
ANN = Path("annotations") / "person_keypoints_val2017.json"
IMAGES = Path("images") / "val2017"
BATCH = 16


def w48_cfg(root: str):
    """The JAX W48-pure-en6 preset reading the fixture at ``root``, B=16."""
    from i2rnet_tpu.presets import w48_pure_en6

    cfg = w48_pure_en6().clone()
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.TEST.BATCH_SIZE_PER_GPU = BATCH
    return cfg


def decoded_digests(root) -> str:
    """``decoded.sha256``: each image as ``cv2.imread`` decodes it."""
    import cv2

    lines = []
    for path in sorted((Path(root) / IMAGES).glob("*.jpg")):
        img = cv2.imread(str(path), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        lines.append(f"{hashlib.sha256(img.tobytes()).hexdigest()}  {path.name}\n")
    return "".join(lines)


def oracle(_variables, batch):
    return batch["target"]


def jax_expected(root) -> dict:
    """``expected.json``: the JAX ``validate`` with the GT-heatmap oracle."""
    from i2rnet_tpu.core.validate import validate
    from i2rnet_tpu.data.coco import COCODataset

    cfg = w48_cfg(str(root))
    ds = COCODataset(cfg, str(root), "val2017", is_train=False)
    with tempfile.TemporaryDirectory() as out:
        name_value, _ = validate(cfg, ds, model=None, variables=None, output_dir=out,
                                 eval_step_fn=oracle)
        results = json.loads((Path(out) / "results" /
                              "keypoints_val2017_results.json").read_text())
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


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    write_fixture(FIXTURE)
    print(f"wrote {FIXTURE}")
