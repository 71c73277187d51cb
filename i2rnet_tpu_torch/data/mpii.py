"""MPII single-person dataset (16 joints), evaluated by PCKh@0.5.

Port of ``i2rnet_tpu/data/mpii.py`` (reference ``lib/dataset/mpii.py``):
the annotations at ``root/annot/{set}.json`` in MATLAB's 1-based
coordinates (the center moved down by 15 scale units and the scale
enlarged 1.25 times before the -1), one person an image, so the
multi-person batches have N=1; ``evaluate`` scores PCKh@0.5 against
``root/annot/gt_{set}.mat`` (read and written with ``scipy.io``), the
pelvis and thorax left out of the means.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict

import numpy as np

from i2rnet_tpu_torch.data.dataset import PoseDataset

logger = logging.getLogger(__name__)


class MPIIDataset(PoseDataset):
    num_joints = 16
    flip_pairs = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
    upper_body_ids = (7, 8, 9, 10, 11, 12, 13, 14, 15)
    lower_body_ids = (0, 1, 2, 3, 4, 5, 6)

    def __init__(self, cfg, root, image_set, is_train):
        super().__init__(cfg, root, image_set, is_train)
        self.db = self._get_db()
        logger.info("=> mpii %s: %d records", image_set, len(self.db))

    def _get_db(self):
        with open(os.path.join(self.root, "annot", self.image_set + ".json")) as f:
            anno = json.load(f)

        db = []
        for a in anno:
            c = np.array(a["center"], np.float32)
            s = np.array([a["scale"], a["scale"]], np.float32)
            if c[0] != -1:
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1  # MATLAB 1-based

            joints = np.zeros((self.num_joints, 3), np.float32)
            vis = np.zeros((self.num_joints, 3), np.float32)
            if self.image_set != "test":
                j = np.array(a["joints"], np.float32)
                j[:, :2] -= 1
                jv = np.array(a["joints_vis"], np.float32)
                joints[:, :2] = j[:, :2]
                vis[:, 0] = jv
                vis[:, 1] = jv

            # an xywh box from center and scale, for the position mask
            w = s[0] * self.pixel_std
            h = s[1] * self.pixel_std
            box = [float(c[0] - w / 2), float(c[1] - h / 2), float(w), float(h)]
            db.append({
                "image": os.path.join(self.root, "images", a["image"]),
                "image_id": len(db),
                "annos": [{"box": box, "center": c, "scale": s, "joints_3d": joints,
                           "joints_3d_vis": vis, "score": 1}],
            })
        return db

    def evaluate(self, cfg, preds, output_dir, *args, **kwargs):
        """PCKh@0.5 against ``gt_{TEST_SET}.mat`` (reference ``mpii.py:96-181``):
        (``name_value``, the mean)."""
        from scipy.io import loadmat, savemat

        preds = np.asarray(preds)[:, :, 0:2] + 1.0
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            savemat(os.path.join(output_dir, "pred.mat"), mdict={"preds": preds})
        d = cfg["DATASET"]
        if "test" in d["TEST_SET"]:
            return {"Null": 0.0}, 0.0

        sc_bias = 0.6
        gt = loadmat(os.path.join(d["ROOT"], "annot", f"gt_{d['TEST_SET']}.mat"))
        dataset_joints = gt["dataset_joints"]
        jnt_missing = gt["jnt_missing"]
        pos_gt_src = gt["pos_gt_src"]
        headboxes_src = gt["headboxes_src"]

        pos_pred_src = np.transpose(preds, [1, 2, 0])

        def jid(name):
            return int(np.where(dataset_joints == name)[1][0])

        jnt_visible = 1 - jnt_missing
        uv_err = np.linalg.norm(pos_pred_src - pos_gt_src, axis=1)
        headsizes = np.linalg.norm(headboxes_src[1] - headboxes_src[0], axis=0) * sc_bias
        scaled = uv_err / headsizes[None, :] * jnt_visible
        jnt_count = np.sum(jnt_visible, axis=1)
        pckh = 100.0 * np.sum((scaled <= 0.5) * jnt_visible, axis=1) / jnt_count

        rng = np.arange(0, 0.5 + 0.01, 0.01)
        pck_all = np.stack([100.0 * np.sum((scaled <= t) * jnt_visible, axis=1) / jnt_count
                            for t in rng])

        pckh = np.ma.array(pckh, mask=False)
        pckh.mask[6:8] = True
        jnt_count = np.ma.array(jnt_count, mask=False)
        jnt_count.mask[6:8] = True
        jnt_ratio = jnt_count / np.sum(jnt_count).astype(np.float64)

        name_value = OrderedDict([
            ("Head", pckh[jid("head")]),
            ("Shoulder", 0.5 * (pckh[jid("lsho")] + pckh[jid("rsho")])),
            ("Elbow", 0.5 * (pckh[jid("lelb")] + pckh[jid("relb")])),
            ("Wrist", 0.5 * (pckh[jid("lwri")] + pckh[jid("rwri")])),
            ("Hip", 0.5 * (pckh[jid("lhip")] + pckh[jid("rhip")])),
            ("Knee", 0.5 * (pckh[jid("lkne")] + pckh[jid("rkne")])),
            ("Ankle", 0.5 * (pckh[jid("lank")] + pckh[jid("rank")])),
            ("Mean", np.sum(pckh * jnt_ratio)),
            ("Mean@0.1", np.sum(pck_all[11, :] * jnt_ratio)),
        ])
        return name_value, name_value["Mean"]
