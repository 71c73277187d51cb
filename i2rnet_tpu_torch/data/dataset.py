"""Base multi-person pose dataset and static-shape batcher.

Port of ``i2rnet_tpu/data/dataset.py``. The host does the cheap numpy work:
decode images (``data/jpeg.py``, in place of ``cv2.imread``), shrink one that
does not fit the static raster (``data/resize.py``, in place of
``cv2.resize``), draw the training augmentation, build each person's affine
matrices and joint coordinates, select persons by the patch modes and group
them into ``[B, N_bucket]`` batches. The pixel work (crop warp, position
masks, normalisation, targets) runs on the device
(``ops/preprocess.py::device_preprocess``).

Reference counterparts: ``JointsDataset.__getitem__`` (``lib/dataset/
JointsDataset.py:207-357``: augmentation, per-person warps), the
``collater`` patch modes (``lib/dataset/collater.py:28-95``: ``random``,
``random_totally``, ``window``, ``main_target``), and the ragged concat with
a ``length`` meta, replaced by ``[B, N_bucket, ...]`` plus ``person_valid``.

The draws are the JAX package's, call for call: ``train_batches`` takes the
epoch's order and the patch choices from its ``rng``, ``make_raw_batch``
each image's rotation, scale, half-body flag and flip from its own, and
``half_body_transform`` its upper/lower choice from the global
``np.random`` stream, as the reference does (``JointsDataset.py:71-114``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from i2rnet_tpu_torch.core.trainer import raw_to_device
from i2rnet_tpu_torch.data.jpeg import imread
from i2rnet_tpu_torch.data.resize import resize_linear
from i2rnet_tpu_torch.ops.preprocess import device_preprocess, np_rotate_bound_resize_affine
from i2rnet_tpu_torch.ops.transforms import np_get_affine_transform

logger = logging.getLogger(__name__)

PERSON_BUCKETS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 32, 48, 64)


def bucket_persons(n: int) -> int:
    for b in PERSON_BUCKETS:
        if n <= b:
            return b
    return n


def _np_affine_point(t: np.ndarray, pt: np.ndarray) -> np.ndarray:
    return t[:, :2] @ pt + t[:, 2]


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose 2x3 affines: result(x) = a(b(x))."""
    a3 = np.vstack([a, [0, 0, 1]])
    b3 = np.vstack([b, [0, 0, 1]])
    return (a3 @ b3)[:2].astype(np.float32)


def _check_axis_aligned(crop_affines: np.ndarray) -> None:
    """Evaluation crop affines are axis-aligned (no rotation; the pre-scale
    and the flip fold into the diagonal), which the device's separable crop
    relies on. A rot=0 composition leaves ~1e-16 trig residue in the
    off-diagonals; anything above float noise means a rotation."""
    if not crop_affines.size:
        return
    off_diag = max(float(np.abs(crop_affines[..., 0, 1]).max()),
                   float(np.abs(crop_affines[..., 1, 0]).max()))
    if off_diag >= 1e-6:
        raise AssertionError("eval batch has rotated crop affines; axis-aligned crop "
                             f"invariant broken (max off-diagonal {off_diag})")


class PoseDataset:
    """Base class. Subclasses populate ``self.db`` (one record per image with
    an ``annos`` list) and implement ``evaluate``. ``cfg`` is the port's dict
    config (``presets.py``)."""

    num_joints = 17
    flip_pairs: List[List[int]] = []
    upper_body_ids: Tuple[int, ...] = ()
    lower_body_ids: Tuple[int, ...] = ()
    # per-joint loss weights (limb up-weighting), applied when
    # LOSS.USE_DIFFERENT_JOINTS_WEIGHT (reference JointsDataset.py:432-433)
    joints_weight: Tuple[float, ...] = ()
    pixel_std = 200

    def __init__(self, cfg: Dict, root: str, image_set: str, is_train: bool):
        self.root = root
        self.image_set = image_set
        self.is_train = is_train
        m, d = cfg["MODEL"], cfg["DATASET"]

        # joint count follows the config (tiny synthetic sets use fewer)
        self.num_joints = m["NUM_JOINTS"]
        self.flip_pairs = [p for p in type(self).flip_pairs
                           if p[0] < self.num_joints and p[1] < self.num_joints]
        self.upper_body_ids = tuple(j for j in type(self).upper_body_ids if j < self.num_joints)
        self.lower_body_ids = tuple(j for j in type(self).lower_body_ids if j < self.num_joints)
        jw = tuple(type(self).joints_weight)[:self.num_joints]
        use_jw = cfg["LOSS"]["USE_DIFFERENT_JOINTS_WEIGHT"] and len(jw) == self.num_joints
        self.joints_weight = jw if use_jw else None

        self.image_width, self.image_height = m["IMAGE_SIZE"]
        self.heatmap_width, self.heatmap_height = m["HEATMAP_SIZE"]
        self.aspect_ratio = self.image_width / self.image_height
        self.sigma = m["SIGMA"]

        self.scale_factor = d["SCALE_FACTOR"]
        self.rotation_factor = d["ROT_FACTOR"]
        self.flip = d["FLIP"]
        self.prob_half_body = d["PROB_HALF_BODY"]
        self.num_joints_half_body = d["NUM_JOINTS_HALF_BODY"]
        self.color_rgb = d["COLOR_RGB"]

        self.max_patch = d["MAX_PATCH"]
        self.patch_mode = d["PATCH_MODE"]
        # static raw-image raster (the device's crop source)
        self.max_image_hw = tuple(cfg["DEVICE"]["MAX_IMAGE_HW"])

        self.db: List[Dict] = []

    # ------------------------------------------------------------------ db
    def __len__(self):
        return len(self.db)

    def _box2cs(self, box) -> Tuple[np.ndarray, np.ndarray]:
        """xywh box -> (center, scale), aspect-fixed, 1.25x enlarged
        (reference ``lib/dataset/coco.py:252-271``)."""
        x, y, w, h = box[:4]
        center = np.array([x + (w - 1) * 0.5, y + (h - 1) * 0.5], np.float32)
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / self.pixel_std, h / self.pixel_std], np.float32)
        if center[0] != -1:
            scale = scale * 1.25
        return center, scale

    def half_body_transform(self, joints, joints_vis):
        """Reference ``JointsDataset.py:71-114``. The upper/lower choice draws
        from the global ``np.random`` stream, not from the batch's ``rng``, as
        the JAX package and the reference do."""
        upper, lower = [], []
        for j in range(self.num_joints):
            if joints_vis[j, 0] > 0:
                (upper if j in self.upper_body_ids else lower).append(joints[j])
        if np.random.randn() < 0.5 and len(upper) > 2:
            selected = upper
        else:
            selected = lower if len(lower) > 2 else upper
        if len(selected) < 2:
            return None, None
        selected = np.array(selected, np.float32)
        center = selected.mean(axis=0)[:2]
        lt = selected.min(axis=0)
        rb = selected.max(axis=0)
        w = rb[0] - lt[0] + 1
        h = rb[1] - lt[1] + 1
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / self.pixel_std, h / self.pixel_std], np.float32) * 1.5
        return center, scale

    def select_data(self, db: List[Dict]) -> List[Dict]:
        """``DATASET.SELECT_DATA`` quality filter (reference
        ``JointsDataset.py:360-391``): keep persons whose joint centroid is
        close to the box center relative to the box area (an OKS-style
        ks > metric(num_visible) test). Image records left empty are dropped."""
        out = []
        kept = dropped = 0
        for rec in db:
            annos = []
            for a in rec["annos"]:
                joints = np.asarray(a["joints_3d"], np.float32)
                vis = np.asarray(a["joints_3d_vis"], np.float32)
                sel = vis[:, 0] > 0
                num_vis = int(np.count_nonzero(sel))
                if num_vis == 0:
                    dropped += 1
                    continue
                joints_center = joints[sel, :2].mean(axis=0)
                bbox_center = np.asarray(a["center"], np.float32)
                scale = np.asarray(a["scale"], np.float32)
                area = scale[0] * scale[1] * (self.pixel_std ** 2)
                diff = np.linalg.norm(joints_center - bbox_center)
                ks = np.exp(-(diff ** 2) / (0.2 ** 2 * 2.0 * area))
                metric = (0.2 / 16) * num_vis + 0.45 - 0.2 / 16
                if ks > metric:
                    annos.append(a)
                    kept += 1
                else:
                    dropped += 1
            if annos:
                out.append({**rec, "annos": annos})
        logger.info("select_data: kept %d persons, dropped %d", kept, dropped)
        return out

    # ------------------------------------------------------- patch modes
    def _select_patches(self, annos: List[Dict], rng: np.random.RandomState) -> List[List[int]]:
        """The person-index groups of one training image (reference
        ``collater.get_max_patch``, ``collater.py:28-95``)."""
        n = len(annos)
        mode = self.patch_mode
        mp = self.max_patch
        if mp <= 0:
            return [list(range(n))]
        origins = np.array([[a["box"][0], a["box"][1]] for a in annos], np.float32)

        def nearest(target_idx, count):
            d = np.linalg.norm(origins - origins[target_idx], axis=1)
            return list(np.argsort(d, kind="stable")[:count])

        if mode == "main_target":
            if n <= 1:
                return [list(range(n))]
            return [nearest(t, min(n, mp)) for t in range(n)]
        if n <= mp:
            return [list(range(n))]
        if mode == "random_totally":
            return [list(rng.choice(n, mp, replace=False))]
        if mode == "window":
            return [list(range(i, min(i + mp, n))) for i in range(0, n, mp)]
        # 'random': the mp persons nearest to a random target person
        return [nearest(rng.randint(n), mp)]

    # --------------------------------------------------------- batching
    def _load_image(self, path: str) -> np.ndarray:
        return imread(path, rgb=self.color_rgb)

    def make_raw_batch(self, items: Sequence[Tuple[int, Optional[List[int]]]], n_max: int,
                       rng: Optional[np.random.RandomState] = None):
        """Assemble a host batch.

        items: list of (db_index, person_indices or None=all). A training
        dataset given ``rng`` draws the image-level augmentation from it.
        Returns (raw dict for ``device_preprocess``, meta dict).
        """
        b = len(items)
        k = self.num_joints
        max_h, max_w = self.max_image_hw
        iw, ih = self.image_width, self.image_height
        hw_, hh_ = self.heatmap_width, self.heatmap_height

        images = np.zeros((b, max_h, max_w, 3), np.uint8)
        crop_affines = np.zeros((b, n_max, 2, 3), np.float32)
        crop_affines[..., 0, 0] = 1.0
        crop_affines[..., 1, 1] = 1.0
        mask_affines = crop_affines.copy()
        boxes = np.full((b, n_max, 4), -1e6, np.float32)
        joints_hm = np.zeros((b, n_max, k, 2), np.float32)
        joints_vis = np.zeros((b, n_max, k), np.float32)
        person_valid = np.zeros((b, n_max), bool)

        meta = {"center": np.zeros((b, n_max, 2), np.float32),
                "scale": np.zeros((b, n_max, 2), np.float32),
                "score": np.ones((b, n_max), np.float32),
                "image_id": np.zeros((b, n_max), np.int64),
                "image_path": [["" for _ in range(n_max)] for _ in range(b)],
                "joints": np.zeros((b, n_max, k, 3), np.float32),
                "joints_vis": np.zeros((b, n_max, k, 3), np.float32),
                "rotation": np.zeros((b,), np.float32)}

        for bi, (dbi, person_idx) in enumerate(items):
            rec = self.db[dbi]
            img = self._load_image(rec["image"])
            src_h, src_w = img.shape[:2]

            # pre-scale to fit the static raster; fold 1/f into crop affines
            f = min(1.0, max_h / src_h, max_w / src_w)
            if f < 1.0:
                img = resize_linear(img, (int(src_w * f), int(src_h * f)))
            rh, rw = img.shape[:2]
            images[bi, :rh, :rw] = img

            annos = rec["annos"]
            idxs = person_idx if person_idx is not None else list(range(len(annos)))
            idxs = idxs[:n_max]

            # image-level augmentation, shared by all persons (reference
            # JointsDataset.py:235-249)
            r = 0.0
            sf_ratio = 1.0
            half_flag = False
            flipped = False
            if self.is_train and rng is not None:
                rf = self.rotation_factor
                r = float(np.clip(rng.randn() * rf, -rf * 2, rf * 2)) \
                    if rng.rand() <= 0.6 else 0.0
                sf = self.scale_factor
                sf_ratio = float(np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf))
                half_flag = rng.rand() < self.prob_half_body
                flipped = self.flip and rng.rand() <= 0.5
            meta["rotation"][bi] = r

            # working coords = (possibly flipped) source image coords; raster
            # coords = unflipped, pre-scaled. raster -> working:
            #   x_w = W-1 - x_r/f (flip) or x_r/f
            if flipped:
                raster_to_work = np.array([[-1.0 / f, 0, src_w - 1], [0, 1.0 / f, 0]], np.float32)
            else:
                raster_to_work = np.array([[1.0 / f, 0, 0], [0, 1.0 / f, 0]], np.float32)

            mask_aff_base = np_rotate_bound_resize_affine(src_w, src_h, r, iw, ih)

            for pi, ai in enumerate(idxs):
                a = annos[ai]
                joints = np.array(a["joints_3d"], np.float32).copy()
                vis = np.array(a["joints_3d_vis"], np.float32).copy()
                c = np.array(a["center"], np.float32).copy()
                s = np.array(a["scale"], np.float32).copy()
                box = np.array(a["box"][:4], np.float32)  # xywh
                score = float(a.get("score", 1))

                if flipped:
                    joints[:, 0] = src_w - joints[:, 0] - 1
                    perm = np.arange(k)
                    for p0, p1 in self.flip_pairs:
                        perm[p0], perm[p1] = perm[p1], perm[p0]
                    joints = (joints * vis)[perm]
                    vis = vis[perm]
                    c[0] = src_w - c[0] - 1
                    bx1 = src_w - 1 - (box[0] + box[2])
                    box = np.array([bx1, box[1], box[2], box[3]], np.float32)

                if self.is_train:
                    s = s * sf_ratio
                    if np.sum(vis[:, 0]) > self.num_joints_half_body and half_flag:
                        c_h, s_h = self.half_body_transform(joints, vis)
                        if c_h is not None:
                            c, s = c_h, s_h

                trans = np_get_affine_transform(c, s, r, (iw, ih))
                trans_hm = np_get_affine_transform(c, s, r, (hw_, hh_))

                jx = joints[:, :2].copy()
                jhm = jx.copy()
                for j in range(k):
                    if vis[j, 0] > 0:
                        jx[j] = _np_affine_point(trans, joints[j, :2])
                        jhm[j] = _np_affine_point(trans_hm, joints[j, :2])

                crop_affines[bi, pi] = _compose(trans, raster_to_work)
                mask_affines[bi, pi] = mask_aff_base
                x1, y1, w_, h_ = box
                # bilinear ramp bounds of the rasterized rectangle
                # (cv2.rectangle fills integer pixels [trunc(x1)..trunc(x1+w)]
                # inclusive, JointsDataset.py:170); saturated at the image's
                # borders, where cv2.resize clamps its sample coordinates
                x1i, y1i = np.trunc(x1), np.trunc(y1)
                x2i, y2i = np.trunc(x1 + w_), np.trunc(y1 + h_)
                boxes[bi, pi] = [
                    x1i - 1 if x1i > 0 else -1e9,
                    y1i - 1 if y1i > 0 else -1e9,
                    x2i + 1 if x2i < src_w - 1 else 1e9,
                    y2i + 1 if y2i < src_h - 1 else 1e9,
                ]
                joints_hm[bi, pi] = jhm
                joints_vis[bi, pi] = vis[:, 0]
                person_valid[bi, pi] = True

                meta["center"][bi, pi] = c
                meta["scale"][bi, pi] = s
                meta["score"][bi, pi] = score
                meta["image_id"][bi, pi] = rec.get("image_id", 0)
                meta["image_path"][bi][pi] = rec["image"]
                meta["joints"][bi, pi, :, :2] = jx
                meta["joints_vis"][bi, pi] = vis

        raw = {
            "images": images,
            "crop_affines": crop_affines,
            "boxes": boxes,
            "mask_affines": mask_affines,
            "joints_hm": joints_hm,
            "joints_vis": joints_vis,
            "person_valid": person_valid,
        }
        if not self.is_train:
            _check_axis_aligned(crop_affines)
        return raw, meta

    def device_batch(self, raw, device) -> Dict[str, torch.Tensor]:
        """A raw host batch -> the model's batch on ``device`` (crops, position
        masks, targets and validity; ``device_preprocess``). Evaluation
        batches take the axis-aligned crop, training batches (rotated) the
        gather crop."""
        axis_aligned = not self.is_train
        if axis_aligned and isinstance(raw["crop_affines"], np.ndarray):
            _check_axis_aligned(raw["crop_affines"])
        return device_preprocess(raw_to_device(raw, device),
                                 (self.image_width, self.image_height),
                                 (self.heatmap_width, self.heatmap_height),
                                 self.sigma, joints_weight=self.joints_weight,
                                 axis_aligned=axis_aligned)

    # --------------------------------------------------------- iteration
    def eval_batches(self, batch_images: int):
        """Yield (items, n_bucket): images grouped by similar person count so
        the number of (B, N) shapes stays small."""
        order = sorted(range(len(self.db)), key=lambda i: len(self.db[i]["annos"]))
        for i in range(0, len(order), batch_images):
            chunk = order[i:i + batch_images]
            n_bucket = bucket_persons(max(len(self.db[j]["annos"]) for j in chunk))
            yield [(j, None) for j in chunk], n_bucket

    def eval_batches_main_target(self, batch_images: int):
        """Main-target evaluation batches (reference ``validate_main_target``,
        ``lib/core/function.py:289-468``): one item per person, containing
        that person first plus its nearest neighbors; only index 0 of every
        item is scored by the caller."""
        items = []
        for dbi, rec in enumerate(self.db):
            annos = rec["annos"]
            n = len(annos)
            if n <= 1:
                items.append((dbi, list(range(n))))
                continue
            origins = np.array([[a["box"][0], a["box"][1]] for a in annos], np.float32)
            cap = n if self.max_patch <= 0 else min(n, self.max_patch)
            for t in range(n):
                d = np.linalg.norm(origins - origins[t], axis=1)
                items.append((dbi, list(np.argsort(d, kind="stable")[:cap])))
        items.sort(key=lambda it: len(it[1]))
        for i in range(0, len(items), batch_images):
            chunk = items[i:i + batch_images]
            nb = bucket_persons(max(len(it[1]) for it in chunk))
            yield chunk, nb

    def train_batches(self, batch_images: int, rng: np.random.RandomState,
                      shard_index: int = 0, num_shards: int = 1):
        """Yield training (items, n_bucket), the patch mode applied to each
        image of the epoch's order. ``num_shards``/``shard_index`` give
        DistributedSampler-style sharding (reference
        ``tools/ddp_train.py:191``). The bucket is ``MAX_PATCH``'s, so every
        batch has one shape; a trailing partial batch is padded by wrapping
        to the epoch's first items."""
        order = rng.permutation(len(self.db))
        order = order[shard_index::num_shards]
        items: List[Tuple[int, List[int]]] = []
        first_batch: List[Tuple[int, List[int]]] = []
        n_bucket = bucket_persons(min(self.max_patch, 64)) if self.max_patch > 0 else None
        for dbi in order:
            groups = self._select_patches(self.db[dbi]["annos"], rng)
            for g in groups:
                items.append((int(dbi), g))
                if len(first_batch) < batch_images:
                    first_batch.append((int(dbi), g))
                if len(items) == batch_images:
                    nb = n_bucket or bucket_persons(max(len(it[1]) for it in items))
                    yield items, nb
                    items = []
        if items:
            # the static-shape analogue of DistributedSampler's wrap-around
            # padding
            i = 0
            while len(items) < batch_images and first_batch:
                items.append(first_batch[i % len(first_batch)])
                i += 1
            nb = n_bucket or bucket_persons(max(len(it[1]) for it in items))
            yield items, nb
