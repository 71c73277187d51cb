"""Draw the skeletons of a results JSON: ``python3 -m i2rnet_tpu_torch.tools.vis_demo``.

Port of ``tools/vis_demo.py`` of the JAX package (reference
``vis_demo.py``), with its flags: the persons scored at least
``--score-thresh`` drawn onto their images (``utils/vis.py::draw_skeleton``,
Pillow), the first ``--limit`` images in image-id order written to
``--out-dir`` under their own names; an image that cannot be read is
skipped.

    python3 -m i2rnet_tpu_torch.tools.vis_demo --results results.json \\
        --image-root images/val2017 --out-dir vis/ [--score-thresh 0.3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import List, Optional

import numpy as np
from PIL import Image

from i2rnet_tpu_torch.utils.vis import JPEG_QUALITY, draw_skeleton


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Draw the skeletons of a results JSON")
    p.add_argument("--results", required=True, help="keypoint results JSON")
    p.add_argument("--image-root", required=True)
    p.add_argument("--out-dir", default="vis_out")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--pattern", default="{:012d}.jpg", help="image filename pattern from image_id")
    p.add_argument("--limit", type=int, default=50)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Draw as the arguments say; the files written."""
    args = parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    by_image = defaultdict(list)
    for r in results:
        if r["score"] >= args.score_thresh:
            by_image[r["image_id"]].append(r)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for i, (img_id, persons) in enumerate(sorted(by_image.items())):
        if i >= args.limit:
            break
        path = os.path.join(args.image_root, args.pattern.format(img_id))
        try:
            img = np.asarray(Image.open(path).convert("RGB"))
        except OSError:
            continue
        for person in persons:
            img = draw_skeleton(img, np.asarray(person["keypoints"], np.float32).reshape(-1, 3))
        out = os.path.join(args.out_dir, os.path.basename(path))
        Image.fromarray(img).save(out, quality=JPEG_QUALITY)
        written.append(out)
    print(f"wrote visualizations to {args.out_dir}")
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
