"""OCHuman dataset (COCO-format, 17 joints, heavy occlusion).

Port of ``i2rnet_tpu/data/ochuman.py`` (reference ``lib/dataset/
ochuman.py``): ``image_set`` names the annotation JSON itself (relative to
``root``), images are ``root/images/{id:06d}.jpg``, and scoring follows the
COCO keypoint protocol. ``TEST.DETAIL_EVAL`` (the crowd-stratified report,
with cluster mode [1, 2] here) raises, as in COCO.

``coco_ochuman`` (reference ``lib/dataset/coco_ochuman.py``), a
COCO-configured run scored on OCHuman data, is the same layout under its own
name (the JAX class's docstring gives the reasons).
"""

from __future__ import annotations

import os

from i2rnet_tpu_torch.data.coco import COCODataset


class OCHumanDataset(COCODataset):
    num_joints = 17
    # reference ochuman.py:450-459: KeypointEvaluator with cluster_mode [1, 2]
    # -> levels c1={1 person}, c2={2+ persons}
    detail_cluster_mode = (1, 2)

    def _ann_file(self):
        return os.path.join(self.root, self.image_set)

    def image_path(self, index: int) -> str:
        return os.path.join(self.root, "images", f"{index:06d}.jpg")

    def _skip_scoring(self) -> bool:
        # the released eval files are named *_test_range_*.json but carry
        # public GT; the reference scores them unconditionally (its 'test'
        # guard is commented out, ochuman.py:371-373,383)
        return False


class CocoOCHumanDataset(OCHumanDataset):
    """Transfer evaluation: a COCO-configured run scored on OCHuman data, in
    the OCHuman layout (``root/{image_set}``, ``images/{id:06d}.jpg``); only
    the registry name differs."""
