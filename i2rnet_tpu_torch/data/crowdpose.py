"""CrowdPose dataset (14 joints).

Port of ``i2rnet_tpu/data/crowdpose.py`` (reference ``lib/dataset/
crowdpose.py``). It differs from COCO in the annotation file
(``root/json/crowdpose_{set}.json``), the images (``root/images/{id}.jpg``),
the 14-joint skeleton with its own flip pairs, half-body split and limb
weights, and the evaluation protocol: AP/AR and AP easy, medium and hard,
banded by each image's ``crowdIndex``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.ops.cocoeval import KeypointEval
from i2rnet_tpu_torch.presets import (CROWDPOSE_FLIP_PAIRS, CROWDPOSE_JOINTS_WEIGHT,
                                      CROWDPOSE_LOWER_BODY_IDS, CROWDPOSE_UPPER_BODY_IDS)


class CROWDPOSEDataset(COCODataset):
    num_joints = 14
    flip_pairs = CROWDPOSE_FLIP_PAIRS
    upper_body_ids = CROWDPOSE_UPPER_BODY_IDS
    lower_body_ids = CROWDPOSE_LOWER_BODY_IDS
    joints_weight = CROWDPOSE_JOINTS_WEIGHT

    def _ann_file(self):
        return os.path.join(self.root, "json", f"crowdpose_{self.image_set}.json")

    def image_path(self, index: int) -> str:
        return os.path.join(self.root, "images", f"{index}.jpg")

    def _skip_scoring(self) -> bool:
        # the eval split is named 'test' and has public GT: the reference
        # scores it unconditionally (crowdpose.py:394-396)
        return False

    def _crowd_index(self):
        return {im["id"]: float(im.get("crowdIndex", 0.0))
                for im in self.coco.dataset.get("images", [])}

    def _score(self, res_file):
        with open(res_file) as f:
            results = json.load(f)
        dt = defaultdict(list)
        for r in results:
            dt[r["image_id"]].append({"keypoints": r["keypoints"], "score": r["score"]})
        ev = KeypointEval(self._gt_for_eval(), dt, num_joints=self.num_joints,
                          crowd_index=self._crowd_index())
        return ev.summarize_crowdpose()
