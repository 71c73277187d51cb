"""COCO keypoints dataset (17 joints): GT-grouped and detector-box modes.

Port of ``i2rnet_tpu/data/coco.py`` (reference ``lib/dataset/coco.py``):

* GT mode groups all annotated persons of an image into one db record
  (:163-249): sanitized boxes, annotations without keypoints skipped, the
  ``USE_COCOMINI`` filter, the ``window`` pre-split;
* detector mode reads ``TEST.COCO_BBOX_FILE``, thresholds by ``IMAGE_THRE``,
  one single-person record per box (:298-343);
* ``evaluate``: regroup predictions per image, rescore
  ``box_score * mean(kpt conf > IN_VIS_THRE)``, OKS-NMS (or soft), write a
  results JSON, score it with the keypoint evaluator (:345-509); with
  ``TEST.DETAIL_EVAL`` also AP per crowd level (``utils/detail_eval.py``,
  bands ``detail_cluster_mode``) and ``res_eval.txt`` beside the results
  (:488-494).
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict, defaultdict
from typing import Dict

import numpy as np

from i2rnet_tpu_torch.data.coco_format import CocoJson
from i2rnet_tpu_torch.data.dataset import PoseDataset
from i2rnet_tpu_torch.ops.cocoeval import KeypointEval
from i2rnet_tpu_torch.ops.nms import oks_nms, soft_oks_nms
from i2rnet_tpu_torch.presets import (COCO_FLIP_PAIRS, COCO_JOINTS_WEIGHT,
                                      COCO_LOWER_BODY_IDS, COCO_UPPER_BODY_IDS)
from i2rnet_tpu_torch.utils.detail_eval import DEFAULT_CLUSTER_MODE, detail_evaluate

logger = logging.getLogger(__name__)


class COCODataset(PoseDataset):
    num_joints = 17
    # TEST.DETAIL_EVAL's crowd bands (reference KeypointEvaluator.py:482)
    detail_cluster_mode = DEFAULT_CLUSTER_MODE
    flip_pairs = COCO_FLIP_PAIRS
    upper_body_ids = COCO_UPPER_BODY_IDS
    lower_body_ids = COCO_LOWER_BODY_IDS
    joints_weight = COCO_JOINTS_WEIGHT

    def __init__(self, cfg: Dict, root: str, image_set: str, is_train: bool):
        super().__init__(cfg, root, image_set, is_train)
        test = cfg["TEST"]
        self.use_gt_bbox = test["USE_GT_BBOX"]
        self.bbox_file = test["COCO_BBOX_FILE"]
        self.image_thre = test["IMAGE_THRE"]
        self.in_vis_thre = test["IN_VIS_THRE"]
        self.oks_thre = test["OKS_THRE"]
        self.soft_nms = test["SOFT_NMS"]
        self.use_cocomini = cfg["DATASET"]["USE_COCOMINI"]

        self.coco = CocoJson(self._ann_file())
        self.person_cat = self.coco.person_cat_id()
        self.db = self._get_db()
        if is_train and cfg["DATASET"]["SELECT_DATA"]:
            self.db = self.select_data(self.db)
        logger.info("=> coco %s: %d records", image_set, len(self.db))

    # --------------------------------------------------------------- paths
    def _ann_file(self):
        prefix = "person_keypoints" if "test" not in self.image_set else "image_info"
        return os.path.join(self.root, "annotations", f"{prefix}_{self.image_set}.json")

    def image_path(self, index: int) -> str:
        file_name = f"{index:012d}.jpg"
        if "2014" in self.image_set:
            file_name = f"COCO_{self.image_set}_{file_name}"
        prefix = "test2017" if "test" in self.image_set else self.image_set
        return os.path.join(self.root, "images", prefix, file_name)

    # ------------------------------------------------------------------ db
    def _get_db(self):
        if self.is_train or self.use_gt_bbox:
            return self._load_gt_db()
        return self._load_detection_db()

    def _image_annos(self, img_id):
        """Sanitized person annos of one image (reference coco.py:163-225)."""
        im = self.coco.load_img(img_id)
        width, height = im["width"], im["height"]
        recs = []
        for obj in self.coco.get_anns(img_id, iscrowd=False):
            if obj.get("category_id") != self.person_cat:
                continue
            x, y, w, h = obj["bbox"]
            x1, y1 = max(0, x), max(0, y)
            x2 = min(width - 1, x1 + max(0, w - 1))
            y2 = min(height - 1, y1 + max(0, h - 1))
            if obj.get("area", 0) <= 0 or x2 < x1 or y2 < y1:
                continue
            if max(obj.get("keypoints", [0])) == 0:
                continue
            clean = [x1, y1, x2 - x1 + 1, y2 - y1 + 1]
            kp = np.asarray(obj["keypoints"], np.float32).reshape(-1, 3)
            joints = np.zeros((self.num_joints, 3), np.float32)
            vis = np.zeros((self.num_joints, 3), np.float32)
            joints[:, :2] = kp[:, :2]
            v = np.minimum(kp[:, 2], 1.0)
            vis[:, 0] = v
            vis[:, 1] = v
            center, scale = self._box2cs(clean)
            recs.append({
                "box": clean,
                "center": center,
                "scale": scale,
                "joints_3d": joints,
                "joints_3d_vis": vis,
                "score": 1,
            })
        return recs

    def _load_gt_db(self):
        db = []
        for img_id in self.coco.get_img_ids():
            recs = self._image_annos(img_id)
            if not recs:
                continue
            if self.use_cocomini and self.image_set == "train2017" and len(recs) <= 1:
                continue
            path = self.image_path(img_id)
            if self.patch_mode == "window" and self.max_patch > 0 and len(recs) > self.max_patch:
                for i in range(0, len(recs), self.max_patch):
                    db.append({"image": path, "image_id": img_id,
                               "annos": recs[i:i + self.max_patch]})
            else:
                db.append({"image": path, "image_id": img_id, "annos": recs})
        return db

    def _load_detection_db(self):
        with open(self.bbox_file) as f:
            all_boxes = json.load(f)
        db = []
        for det in all_boxes:
            if det.get("category_id") != 1:
                continue
            if det["score"] < self.image_thre:
                continue
            center, scale = self._box2cs(det["bbox"])
            db.append({
                "image": self.image_path(det["image_id"]),
                "image_id": det["image_id"],
                "annos": [{
                    "box": det["bbox"],
                    "center": center,
                    "scale": scale,
                    "score": det["score"],
                    "joints_3d": np.zeros((self.num_joints, 3), np.float32),
                    "joints_3d_vis": np.ones((self.num_joints, 3), np.float32),
                }],
            })
        logger.info("=> detector boxes kept@%s: %d", self.image_thre, len(db))
        return db

    # ------------------------------------------------------------ evaluate
    def evaluate(self, cfg, preds, output_dir, all_boxes, image_ids):
        """Score predictions: (``name_value``, AP).

        preds [M, K, 3] source-image coords + conf; all_boxes [M, 6]
        (center, scale, area, score); image_ids [M]. ``TEST.DETAIL_EVAL``
        adds AP per crowd level to ``name_value`` and writes ``res_eval.txt``
        beside the results JSON (JAX ``coco.py:198-212``).
        """
        res_folder = os.path.join(output_dir, "results")
        os.makedirs(res_folder, exist_ok=True)
        res_file = os.path.join(res_folder, f"keypoints_{self.image_set}_results.json")

        kpts = defaultdict(list)
        for idx in range(len(preds)):
            kpts[int(image_ids[idx])].append({
                "keypoints": np.asarray(preds[idx]),
                "center": all_boxes[idx][0:2],
                "scale": all_boxes[idx][2:4],
                "area": float(all_boxes[idx][4]),
                "score": float(all_boxes[idx][5]),
                "image": int(image_ids[idx]),
            })

        # rescoring + OKS-NMS (reference coco.py:380-412)
        nmsed = []
        for img_kpts in kpts.values():
            for p in img_kpts:
                box_score = p["score"]
                conf = p["keypoints"][:, 2]
                m = conf > self.in_vis_thre
                kpt_score = float(conf[m].mean()) if m.any() else 0.0
                p["score"] = kpt_score * box_score
            nms_fn = soft_oks_nms if self.soft_nms else oks_nms
            keep = nms_fn(img_kpts, self.oks_thre, num_joints=self.num_joints)
            nmsed.append([img_kpts[i] for i in keep] if keep else img_kpts)

        self._write_results(nmsed, res_file)
        if self._skip_scoring():
            return {"Null": 0}, 0
        info = self._score(res_file)
        name_value = OrderedDict(info)
        if cfg["TEST"]["DETAIL_EVAL"]:
            name_value.update(detail_evaluate(
                self._gt_for_eval(), self._read_results(res_file), num_joints=self.num_joints,
                cluster_mode=self.detail_cluster_mode,
                report_path=os.path.join(res_folder, "res_eval.txt"), all_stats=info))
        return name_value, name_value["AP"]

    def _skip_scoring(self) -> bool:
        """COCO test-dev has no public GT, so scoring is skipped for 'test'
        image sets (reference coco.py:427-432)."""
        return "test" in self.image_set

    def _write_results(self, nmsed, res_file):
        results = []
        for img_kpts in nmsed:
            for p in img_kpts:
                kp = np.asarray(p["keypoints"], np.float64)
                results.append({
                    "image_id": p["image"],
                    "category_id": 1,
                    "keypoints": [round(float(v), 3) for v in kp.reshape(-1)],
                    "score": float(p["score"]),
                    "center": [float(c) for c in np.asarray(p["center"]).reshape(-1)],
                    "scale": [float(s) for s in np.asarray(p["scale"]).reshape(-1)],
                })
        with open(res_file, "w") as f:
            json.dump(results, f, sort_keys=True, indent=4)

    def _gt_for_eval(self):
        gt = defaultdict(list)
        for img_id in self.coco.get_img_ids():
            for obj in self.coco.get_anns(img_id, iscrowd=None):
                if obj.get("category_id") != self.person_cat:
                    continue
                gt[img_id].append({
                    "id": obj["id"],
                    "keypoints": obj.get("keypoints", [0] * (self.num_joints * 3)),
                    "area": obj.get("area", 0),
                    "bbox": obj.get("bbox", [0, 0, 0, 0]),
                    "iscrowd": obj.get("iscrowd", 0),
                    "num_keypoints": obj.get("num_keypoints",
                                             int(np.count_nonzero(
                                                 np.asarray(obj.get("keypoints", []))[2::3]))),
                })
        return gt

    @staticmethod
    def _read_results(res_file):
        """The results JSON as the evaluator's detections, per image."""
        with open(res_file) as f:
            results = json.load(f)
        dt = defaultdict(list)
        for r in results:
            dt[r["image_id"]].append({"keypoints": r["keypoints"], "score": r["score"]})
        return dt

    def _score(self, res_file):
        ev = KeypointEval(self._gt_for_eval(), self._read_results(res_file),
                          num_joints=self.num_joints)
        return ev.summarize_coco()
