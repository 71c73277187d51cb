"""Minimal COCO-format annotation parsing (pycocotools is not used).

A copy of ``i2rnet_tpu/data/coco_format.py``: the indexing the datasets
need (images, per-image person annotations, category lookup). Works for
COCO, OCHuman (COCO-format) and CrowdPose (the same JSON structure with 14
keypoints and a per-image ``crowdIndex``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List


class CocoJson:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs: Dict[int, Dict] = {im["id"]: im for im in d.get("images", [])}
        self.anns: Dict[int, Dict] = {a["id"]: a for a in d.get("annotations", [])}
        self.img_to_anns: Dict[int, List[Dict]] = defaultdict(list)
        for a in d.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
        self.cats = {c["id"]: c for c in d.get("categories", [])}

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_img(self, img_id: int) -> Dict[str, Any]:
        return self.imgs[img_id]

    def get_anns(self, img_id: int, iscrowd: bool = False) -> List[Dict]:
        anns = self.img_to_anns.get(img_id, [])
        if iscrowd is None:
            return anns
        return [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]

    def person_cat_id(self) -> int:
        for cid, c in self.cats.items():
            if c.get("name") == "person":
                return cid
        return 1
