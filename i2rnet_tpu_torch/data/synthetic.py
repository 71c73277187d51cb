"""Synthetic data made with numpy from a seed: raw training batches and
COCO, CrowdPose and OCHuman image trees with their detections.

``synthetic_raw_batch`` builds a raw host batch in ``device_preprocess``'s
contract, as the JAX ``PoseDataset.make_raw_batch`` builds one for training
(``data/dataset.py:226-390``): per image a random uint8 raster and a
rotation shared by its persons; per person a box inside the image, its
center and scale (reference ``coco.py:175-196``: aspect-ratio fix, /200,
x1.25), the crop affine ``np_get_affine_transform(c, s, r)``, the
position-mask affine of ``rotate_bound(r)`` + resize, the box's ramp bounds,
and joints inside the box (visible with probability 0.8) mapped to heatmap
pixels. Padded slots carry identity affines, far-away boxes and
``person_valid`` False. No flip, pre-scaling or half-body augmentation.

``make_synthetic_coco``, ``make_synthetic_crowdpose``,
``make_synthetic_ochuman`` and ``make_synthetic_detections`` are the JAX
package's makers (``i2rnet_tpu/data/synthetic.py``): the same signatures,
the same draws from ``np.random.RandomState(seed)`` in the same order, the
same file names and the same ``json.dump`` calls, so the annotation and
detection files are the same bytes. Each image is a dark random raster with
one "stick figure" a person: a box outline and a dot a visible joint. The
JAX makers draw them with OpenCV; here they are numpy rules with OpenCV's
pixel sets (``_rectangle``, ``_disc``), clipped at the border as OpenCV
clips them, so the rasters are the same bits. Every image goes through
``_imwrite``, which encodes as ``cv2.imwrite`` does by default (baseline
JPEG, quality 95, 4:2:0) with Pillow; with the same libjpeg-turbo the files
are the same bytes (``tests/test_torch_synthetic.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from i2rnet_tpu_torch.ops.preprocess import np_rotate_bound_resize_affine
from i2rnet_tpu_torch.ops.transforms import np_get_affine_transform


def _box_center_scale(x, y, w, h, aspect: float):
    c = np.array([x + (w - 1) / 2, y + (h - 1) / 2], np.float32)
    if w > aspect * h:
        h = w / aspect
    else:
        w = h * aspect
    return c, np.array([w / 200.0, h / 200.0], np.float32) * 1.25


def synthetic_raw_batch(cfg: Dict, person_counts: Sequence[int], rng: np.random.RandomState,
                        n_max: int = None, raw_hw: Tuple[int, int] = (480, 640),
                        max_rotation: float = 30.0) -> Dict[str, np.ndarray]:
    """One raw batch of ``len(person_counts)`` images with that many persons
    each, padded to ``n_max`` (default ``DATASET.MAX_PATCH``) person slots."""
    m = cfg["MODEL"]
    iw, ih = m["IMAGE_SIZE"]
    hw, hh = m["HEATMAP_SIZE"]
    k = m["NUM_JOINTS"]
    n_max = n_max or cfg["DATASET"]["MAX_PATCH"]
    b = len(person_counts)
    H, W = raw_hw
    raw = {
        "images": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
        "crop_affines": np.tile(np.eye(2, 3, dtype=np.float32), (b, n_max, 1, 1)),
        "boxes": np.full((b, n_max, 4), -1e6, np.float32),
        "mask_affines": np.tile(np.eye(2, 3, dtype=np.float32), (b, n_max, 1, 1)),
        "joints_hm": np.zeros((b, n_max, k, 2), np.float32),
        "joints_vis": np.zeros((b, n_max, k), np.float32),
        "person_valid": np.zeros((b, n_max), bool),
    }
    for bi, count in enumerate(person_counts):
        if count > n_max:
            raise ValueError(f"{count} persons do not fit {n_max} slots")
        r = float(rng.uniform(-max_rotation, max_rotation))
        mask_aff = np_rotate_bound_resize_affine(W, H, r, iw, ih)
        for pi in range(count):
            bw, bh = rng.uniform(W / 8, W / 2), rng.uniform(H / 4, H / 1.5)
            x0, y0 = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
            c, s = _box_center_scale(x0, y0, bw, bh, iw / ih)
            trans_hm = np_get_affine_transform(c, s, r, (hw, hh))
            joints = np.stack([rng.uniform(x0, x0 + bw, k), rng.uniform(y0, y0 + bh, k)], 1)
            vis = (rng.rand(k) < 0.8).astype(np.float32)
            jhm = joints @ trans_hm[:, :2].T + trans_hm[:, 2]
            x1i, y1i = np.trunc(x0), np.trunc(y0)
            x2i, y2i = np.trunc(x0 + bw), np.trunc(y0 + bh)
            raw["crop_affines"][bi, pi] = np_get_affine_transform(c, s, r, (iw, ih))
            raw["mask_affines"][bi, pi] = mask_aff
            raw["boxes"][bi, pi] = [x1i - 1 if x1i > 0 else -1e9, y1i - 1 if y1i > 0 else -1e9,
                                    x2i + 1 if x2i < W - 1 else 1e9,
                                    y2i + 1 if y2i < H - 1 else 1e9]
            raw["joints_hm"][bi, pi] = np.where(vis[:, None] > 0, jhm, joints)
            raw["joints_vis"][bi, pi] = vis
            raw["person_valid"][bi, pi] = True
    return raw


# --------------------------------------------------------- drawn image trees

#: ``cv2.circle(img, c, 3, color, -1)``'s filled disc, as the half-width of
#: each row from dy = -3 to 3 (a fixed 7x7 stencil, not the Euclidean disc)
_DISC_ROWS = (0, 2, 2, 3, 2, 2, 0)


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int, color) -> None:
    """``img[y0..y1, x0..x1] = color``, bounds inclusive, clipped to the image."""
    h, w = img.shape[:2]
    y0, x0, y1, x1 = max(y0, 0), max(x0, 0), min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def _rectangle(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color) -> None:
    """``cv2.rectangle(img, p0, p1, color, 2)`` (8-connected), for
    ``p0 < p1`` in both axes: each edge a 3-pixel band centred on it that
    spans its two corners, so the four outermost corner pixels stay unset
    (OpenCV's thick line ends in a radius-1 round cap)."""
    (x0, y0), (x1, y1) = p0, p1
    for y in (y0, y1):
        _fill(img, y - 1, y + 1, x0, x1, color)
    for x in (x0, x1):
        _fill(img, y0, y1, x - 1, x + 1, color)


def _disc(img: np.ndarray, center: Tuple[int, int], color) -> None:
    """``cv2.circle(img, center, 3, color, -1)`` (8-connected)."""
    cx, cy = center
    for dy, half in enumerate(_DISC_ROWS, -3):
        _fill(img, cy + dy, cy + dy, cx - half, cx + half, color)


def _imwrite(path: str, bgr: np.ndarray) -> None:
    """Write the BGR uint8 raster ``bgr`` as ``cv2.imwrite(path, bgr)`` writes
    a ``.jpg`` by default: baseline, quality 95, 4:2:0, not optimised. Every
    image of the makers below is written here."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(
        path, format="JPEG", quality=95, subsampling=2, optimize=False, progressive=False)


def _draw_person(img: np.ndarray, rng: np.random.RandomState, x0: int, y0: int, pw: int,
                 ph: int, num_joints: int) -> Tuple[List[int], int]:
    """One person's color, box outline and visible joints, drawn in the JAX
    makers' order: (COCO keypoints ``[x, y, v] * num_joints``, visible count)."""
    color = tuple(int(c) for c in rng.randint(80, 255, 3))
    _rectangle(img, (x0, y0), (x0 + pw, y0 + ph), color)
    kps = []
    n_vis = 0
    for j in range(num_joints):
        jx = x0 + int((0.2 + 0.6 * rng.rand()) * pw)
        jy = y0 + int((j + 0.5) / num_joints * ph)
        vis = 2 if rng.rand() > 0.15 else 0
        if vis:
            _disc(img, (jx, jy), color)
            n_vis += 1
        kps.extend([jx, jy, vis])
    return kps, n_vis


def _annotation(ann_id: int, img_id: int, kps, n_vis, x0, y0, pw, ph) -> Dict:
    return {"id": ann_id, "image_id": img_id, "category_id": 1, "keypoints": kps,
            "num_keypoints": n_vis, "bbox": [float(x0), float(y0), float(pw), float(ph)],
            "area": float(pw * ph), "iscrowd": 0}


def _write_annotations(path: str, images, annotations, num_joints: int) -> None:
    ann = {
        "images": images,
        "annotations": annotations,
        "categories": [{
            "id": 1, "name": "person", "supercategory": "person",
            "keypoints": [f"j{i}" for i in range(num_joints)], "skeleton": [],
        }],
    }
    with open(path, "w") as f:
        json.dump(ann, f)


def _box_persons(img, rng, max_persons, num_joints, first_ann_id, img_id):
    """1..``max_persons`` persons at independent places (COCO, CrowdPose)."""
    h, w = img.shape[:2]
    annotations = []
    for _ in range(rng.randint(1, max_persons + 1)):
        pw = rng.randint(40, 80)
        ph = rng.randint(80, 140)
        x0 = rng.randint(0, max(1, w - pw))
        y0 = rng.randint(0, max(1, h - ph))
        kps, n_vis = _draw_person(img, rng, x0, y0, pw, ph, num_joints)
        annotations.append(_annotation(first_ann_id + len(annotations), img_id, kps, n_vis,
                                       x0, y0, pw, ph))
    return annotations


def make_synthetic_coco(root: str, num_images: int = 6,
                        image_hw: Tuple[int, int] = (240, 320),
                        num_joints: int = 17, max_persons: int = 3,
                        image_set: str = "val2017", seed: int = 0) -> str:
    """Create ``images/{image_set}/{id:012d}.jpg`` and
    ``annotations/person_keypoints_{image_set}.json`` under ``root``, ids from
    1. Returns root."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    img_dir = os.path.join(root, "images", image_set)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations = [], []
    for img_id in range(1, num_images + 1):
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        annotations += _box_persons(img, rng, max_persons, num_joints, len(annotations) + 1,
                                    img_id)
        fn = f"{img_id:012d}.jpg"
        _imwrite(os.path.join(img_dir, fn), img)
        images.append({"id": img_id, "file_name": fn, "height": h, "width": w})
    _write_annotations(os.path.join(ann_dir, f"person_keypoints_{image_set}.json"), images,
                       annotations, num_joints)
    return root


def make_synthetic_crowdpose(root: str, num_images: int = 6,
                             image_hw: Tuple[int, int] = (240, 320),
                             max_persons: int = 3, image_set: str = "test",
                             seed: int = 0) -> str:
    """CrowdPose's layout (reference ``lib/dataset/crowdpose.py``): 14 joints,
    ``json/crowdpose_{image_set}.json``, images flat at ``images/{id}.jpg``
    with 6-digit ids from 100001 (its evaluate reads the id as
    ``int(img_path[-10:-4])``), each image's ``crowdIndex`` cycling through
    0.05, 0.4 and 0.9 so that AP (easy), (medium) and (hard) all populate.
    Returns root."""
    rng = np.random.RandomState(seed)
    num_joints = 14
    h, w = image_hw
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "json")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    crowd_levels = [0.05, 0.4, 0.9]
    images, annotations = [], []
    for i in range(num_images):
        img_id = 100001 + i
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        annotations += _box_persons(img, rng, max_persons, num_joints, len(annotations) + 1,
                                    img_id)
        _imwrite(os.path.join(img_dir, f"{img_id}.jpg"), img)
        images.append({"id": img_id, "file_name": f"{img_id}.jpg",
                       "height": h, "width": w,
                       "crowdIndex": crowd_levels[i % 3]})
    _write_annotations(os.path.join(ann_dir, f"crowdpose_{image_set}.json"), images,
                       annotations, num_joints)
    return root


def make_synthetic_ochuman(root: str, num_images: int = 6,
                           image_hw: Tuple[int, int] = (240, 320),
                           max_persons: int = 3,
                           ann_name: str =
                           "ochuman_coco_format_val_range_0.00_1.00.json",
                           seed: int = 0) -> str:
    """OCHuman's layout (reference ``lib/dataset/ochuman.py``): 17 joints, the
    annotation file ``root/{ann_name}`` (point ``DATASET.TEST_SET`` at it),
    images flat at ``images/{id:06d}.jpg`` with ids from 100001. The persons
    of an image share a neighbourhood so their boxes overlap, and even images
    hold at least two, so both crowd bands of the detail report populate.
    Returns root."""
    rng = np.random.RandomState(seed)
    num_joints = 17
    h, w = image_hw
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(root, exist_ok=True)

    images, annotations = [], []
    for i in range(num_images):
        img_id = 100001 + i
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        n_person = (rng.randint(2, max_persons + 1) if i % 2 == 0
                    else rng.randint(1, max_persons + 1))
        cx0 = rng.randint(0, w // 2)
        cy0 = rng.randint(0, h // 3)
        for p in range(n_person):
            pw = rng.randint(40, 80)
            ph = rng.randint(80, 140)
            x0 = min(max(0, cx0 + rng.randint(-10, 30 * p + 11)), w - pw - 1)
            y0 = min(max(0, cy0 + rng.randint(-10, 11)), h - ph - 1)
            kps, n_vis = _draw_person(img, rng, x0, y0, pw, ph, num_joints)
            annotations.append(_annotation(len(annotations) + 1, img_id, kps, n_vis,
                                           x0, y0, pw, ph))
        _imwrite(os.path.join(img_dir, f"{img_id:06d}.jpg"), img)
        images.append({"id": img_id, "file_name": f"{img_id:06d}.jpg",
                       "height": h, "width": w})
    _write_annotations(os.path.join(root, ann_name), images, annotations, num_joints)
    return root


def make_synthetic_detections(root: str, image_set: str = "val2017",
                              seed: int = 1, jitter_px: float = 2.0,
                              dup_every: int = 2, low_score_every: int = 4,
                              out_name: str = None) -> str:
    """A COCO person-detection-results JSON (what ``TEST.COCO_BBOX_FILE``
    names; reference ``lib/dataset/coco.py:298-343``) for the tree that
    :func:`make_synthetic_coco` wrote at ``root``, one ``{image_id,
    category_id, bbox, score}`` entry a detection, derived from the GT boxes:

    * every GT box slightly jittered with a high score (kept);
    * every ``dup_every``-th box also a second, more jittered duplicate at a
      lower score, which OKS-NMS should drop;
    * every ``low_score_every``-th box a 0.1-score entry that
      ``TEST.IMAGE_THRE`` above 0.1 filters out.

    Written to ``annotations/{out_name}`` (default
    ``person_detections_{image_set}.json``); returns that path.
    """
    rng = np.random.RandomState(seed)
    with open(os.path.join(root, "annotations",
                           f"person_keypoints_{image_set}.json")) as f:
        ann = json.load(f)

    def _jit(bbox, px):
        x, y, w, h = bbox
        return [float(x + rng.uniform(-px, px)),
                float(y + rng.uniform(-px, px)),
                float(max(8.0, w + rng.uniform(-px, px))),
                float(max(8.0, h + rng.uniform(-px, px)))]

    dets = []
    for i, a in enumerate(ann["annotations"]):
        dets.append({"image_id": a["image_id"], "category_id": 1,
                     "bbox": _jit(a["bbox"], jitter_px),
                     "score": float(rng.uniform(0.85, 0.99))})
        if dup_every and i % dup_every == 0:
            dets.append({"image_id": a["image_id"], "category_id": 1,
                         "bbox": _jit(a["bbox"], 2.5 * jitter_px),
                         "score": float(rng.uniform(0.45, 0.75))})
        if low_score_every and i % low_score_every == 0:
            dets.append({"image_id": a["image_id"], "category_id": 1,
                         "bbox": _jit(a["bbox"], jitter_px),
                         "score": 0.1})
    det_file = os.path.join(
        root, "annotations", out_name or f"person_detections_{image_set}.json")
    with open(det_file, "w") as f:
        json.dump(dets, f)
    return det_file
