"""Diff two keypoint results JSONs: ``python3 -m i2rnet_tpu_torch.tools.trans_json A.json B.json``.

Port of ``tools/trans_json.py`` of the JAX package (reference
``trans_json.py``, its golden-test mechanism): the entries of A matched to
B's by image id and box centre (rounded to 0.1), the largest keypoint and
score differences printed, exit code 0 when every entry of A is in B and
every keypoint within ``--atol``, else 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import List, Optional

import numpy as np


def index(results):
    """Entries by (image id, centre x, centre y), the centre rounded to 0.1."""
    idx = defaultdict(list)
    for r in results:
        c = r.get("center", [0, 0])
        idx[(r["image_id"], round(c[0], 1), round(c[1], 1))].append(r)
    return idx


def compare(ra, rb, atol: float) -> bool:
    """Print the match and the largest differences; whether they pass."""
    ia, ib = index(ra), index(rb)
    matched = missing = 0
    max_kp = max_score = 0.0
    for key, entries in ia.items():
        if key not in ib:
            missing += len(entries)
            continue
        for ea, eb in zip(entries, ib[key]):
            ka = np.asarray(ea["keypoints"], np.float64)
            kb = np.asarray(eb["keypoints"], np.float64)
            max_kp = max(max_kp, float(np.abs(ka - kb).max()))
            max_score = max(max_score, abs(ea["score"] - eb["score"]))
            matched += 1
    print(f"matched {matched} / {len(ra)} entries; {missing} missing in B")
    print(f"max |keypoint delta| = {max_kp:.4f}, max |score delta| = {max_score:.6f}")
    ok = max_kp <= atol and missing == 0
    print("PASS" if ok else "FAIL")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Diff two keypoint results JSONs")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--atol", type=float, default=1.0)
    args = p.parse_args(argv)
    with open(args.a) as f:
        ra = json.load(f)
    with open(args.b) as f:
        rb = json.load(f)
    return 0 if compare(ra, rb, args.atol) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
