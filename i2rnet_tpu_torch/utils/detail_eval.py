"""Crowd-stratified detail evaluation (``TEST.DETAIL_EVAL``).

Port of ``i2rnet_tpu/utils/detail_eval.py`` (reference ``lib/utils/
KeypointEvaluator.py``): the GT (and the results) split by persons per image
into cluster levels, and AP reported per level, which shows how accuracy
falls with crowding.

The bands are the reference's ``ClusterMode`` (``:528-545``): ``cluster_mode``
lists band start points; level ``c{i}`` covers ``[start[i-1], start[i] - 1]``,
and images with more persons than the last start open one more level:

- ``(1, 2, 6, 10)`` (the default, reference ``:482``): c1={1}, c2={2-5},
  c3={6-9}, c4={10+};
- ``(1, 2)`` (OCHuman, reference ``lib/dataset/ochuman.py:450-459``): c1={1},
  c2={2+}.

:func:`write_report` writes the reference's ``res_eval.txt``
(``KeypointEvaluator.py:436-482``): the all-images stats, then each level's
person-count histogram and stat lines.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from i2rnet_tpu_torch.ops.cocoeval import KeypointEval

#: the reference's default bands (``KeypointEvaluator.py:482``)
DEFAULT_CLUSTER_MODE = (1, 2, 6, 10)
_OPEN = 10 ** 9  # the upper end of the last, open band


def cluster_bands(cluster_mode: Sequence[int]) -> List[Tuple[str, int, int]]:
    """Band start points -> ``[(level, lo, hi)]``, ``hi`` inclusive."""
    pts = list(cluster_mode)
    bands = [(f"c{i + 1}", pts[i], pts[i + 1] - 1) for i in range(len(pts) - 1)]
    bands.append((f"c{len(pts)}", pts[-1], _OPEN))
    return bands


def _band_label(lo: int, hi: int) -> str:
    if lo == hi:
        return f"n={lo}"
    if hi >= _OPEN:
        return f"n>={lo}"
    return f"n={lo}-{hi}"


def detail_evaluate(gt: Dict[int, List[dict]], dt: Dict[int, List[dict]],
                    num_joints: int = 17, cluster_mode: Sequence[int] = DEFAULT_CLUSTER_MODE,
                    sigmas=None, report_path: Optional[str] = None,
                    all_stats=None) -> "OrderedDict[str, float]":
    """AP per crowd level: ``{"AP(c1:n=1)": ..., ...}`` over the levels that
    hold an image (persons with keypoints counted per image).

    With ``report_path`` the reference's ``res_eval.txt`` is written there
    too: ``all_stats`` (the all-images stats, where given), then each
    level's counts and stats."""
    persons = {img: len([g for g in gts if g.get("num_keypoints", 1) > 0])
               for img, gts in gt.items()}
    out = OrderedDict()
    blocks = []
    for level, lo, hi in cluster_bands(cluster_mode):
        ids = {i for i, n in persons.items() if lo <= n <= hi}
        if not ids:
            continue
        ev = KeypointEval({i: gt[i] for i in ids}, {i: dt.get(i, []) for i in ids},
                          num_joints=num_joints, sigmas=sigmas)
        stats = OrderedDict(ev.summarize_coco())
        out[f"AP({level}:{_band_label(lo, hi)})"] = stats["AP"]
        counts = OrderedDict(total=len(ids))
        for n in sorted({persons[i] for i in ids}):
            counts[str(n)] = sum(1 for i in ids if persons[i] == n)
        blocks.append((level, counts, stats))
    if report_path is not None:
        write_report(report_path, blocks, all_stats)
    return out


def write_report(path: str, blocks, all_stats=None) -> None:
    """The reference's ``res_eval.txt``: ``blocks`` are ``(level, counts,
    stats)`` as :func:`detail_evaluate` makes them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n\nAll eval:\n")
        for name, val in dict(all_stats or {}).items():
            f.write(f"('{name}', {val})\n")
        f.write("\n\n")
        for level, counts, stats in blocks:
            f.write(f"Class {level} eval:\n{{\n")
            for k, v in counts.items():
                f.write(f"    {k}:{v}\n")
            f.write("}\n")
            for name, val in stats.items():
                f.write(f"('{name}', {val})\n")
            f.write("\n\n")
