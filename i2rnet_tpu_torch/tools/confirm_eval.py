"""Re-score a keypoint results JSON: ``python3 -m i2rnet_tpu_torch.tools.confirm_eval``.

Port of ``tools/confirm_eval.py`` of the JAX package (reference
``confirm_eval.py``), with its flags and output: the COCO keypoint stats, or
with ``--crowdpose`` the CrowdPose ones (AP easy, medium and hard by each
image's ``crowdIndex``), one line each.

    python3 -m i2rnet_tpu_torch.tools.confirm_eval --results results.json \\
        --ann person_keypoints_val2017.json [--num-joints 17] [--crowdpose]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import List, Optional

import numpy as np

from i2rnet_tpu_torch.data.coco_format import CocoJson
from i2rnet_tpu_torch.ops.cocoeval import KeypointEval


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Re-score a keypoint results JSON")
    p.add_argument("--results", required=True)
    p.add_argument("--ann", required=True, help="COCO-format GT annotations")
    p.add_argument("--num-joints", type=int, default=17)
    p.add_argument("--crowdpose", action="store_true")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Print and return the stats as ``[(name, value)]``."""
    args = parse_args(argv)
    coco = CocoJson(args.ann)
    gt = defaultdict(list)
    for img_id in coco.get_img_ids():
        for obj in coco.get_anns(img_id, iscrowd=None):
            kp = obj.get("keypoints", [])
            gt[img_id].append({
                "id": obj["id"], "keypoints": kp, "area": obj.get("area", 0),
                "bbox": obj.get("bbox", [0, 0, 0, 0]), "iscrowd": obj.get("iscrowd", 0),
                "num_keypoints": obj.get("num_keypoints",
                                         int(np.count_nonzero(np.asarray(kp)[2::3])) if kp
                                         else 0)})
    with open(args.results) as f:
        results = json.load(f)
    dt = defaultdict(list)
    for r in results:
        dt[r["image_id"]].append({"keypoints": r["keypoints"], "score": r["score"]})
    if args.crowdpose:
        ci = {im["id"]: float(im.get("crowdIndex", 0.0)) for im in coco.dataset.get("images", [])}
        stats = KeypointEval(gt, dt, num_joints=args.num_joints,
                             crowd_index=ci).summarize_crowdpose()
    else:
        stats = KeypointEval(gt, dt, num_joints=args.num_joints).summarize_coco()
    for name, val in stats:
        print(f"{name:12s} {val:.4f}")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
