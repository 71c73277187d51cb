"""Skeleton rendering for the demo.

Port of ``draw_skeleton`` in ``i2rnet_tpu/utils/vis.py`` (reference
``vis_demo.py:30-54``) with Pillow's ``ImageDraw`` in place of cv2, on an RGB
image: the same joints, limbs, radii, widths and colours (the JAX table is
BGR, as cv2 takes it; here each colour is its RGB reverse, so the output
looks the same). The ``DEBUG.DEBUG`` grids of that module are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

#: COCO skeleton edges (``i2rnet_tpu/utils/vis.py:17-21``)
COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]
#: the per-joint and per-limb colours (``i2rnet_tpu/utils/vis.py:22-27``, BGR)
_COLORS_BGR = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85), (255, 0, 0),
]
COLORS = [c[::-1] for c in _COLORS_BGR]


def draw_skeleton(image: np.ndarray, keypoints: np.ndarray,
                  skeleton: Optional[Sequence] = None,
                  conf_thresh: float = 0.2) -> np.ndarray:
    """One person's keypoints ``[K, 3]`` (x, y, confidence) drawn onto a copy
    of the uint8 RGB ``image``: a dot of radius 3 per joint above
    ``conf_thresh``, a line of width 2 per limb whose two joints are."""
    img = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(img)
    skeleton = skeleton if skeleton is not None else COCO_SKELETON
    k = len(keypoints)
    for j in range(k):
        x, y, c = keypoints[j]
        if c > conf_thresh:
            draw.ellipse([int(x) - 3, int(y) - 3, int(x) + 3, int(y) + 3],
                         fill=COLORS[j % len(COLORS)])
    for ei, (a, b) in enumerate(skeleton):
        if a < k and b < k and keypoints[a, 2] > conf_thresh and keypoints[b, 2] > conf_thresh:
            draw.line([(int(keypoints[a, 0]), int(keypoints[a, 1])),
                       (int(keypoints[b, 0]), int(keypoints[b, 1]))],
                      fill=COLORS[ei % len(COLORS)], width=2)
    return np.asarray(img)
