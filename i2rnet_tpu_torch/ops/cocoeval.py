"""COCO-keypoint evaluation (OKS-matched AP/AR), from scratch.

A copy of ``i2rnet_tpu/ops/cocoeval.py`` (pure numpy). pycocotools is not
used: this is the JAX package's own evaluator, implementing the standard COCOeval keypoint protocol
(OKS IoU with per-joint sigmas, greedy score-ordered matching per OKS
threshold .50:.05:.95, 101-point interpolated precision, area ranges
all/medium/large, maxDets=20). Consumed by the datasets' ``evaluate``
(reference ``lib/dataset/coco.py:487-509`` calls pycocotools COCOeval).

Also implements the CrowdPose variant: no area partition, plus AP(easy/
medium/hard) stratified by per-image ``crowdIndex`` (bins <=0.1 /
(0.1, 0.8] / >0.8), matching the crowdpose API used at reference
``lib/dataset/crowdpose.py:461-489``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from i2rnet_tpu_torch.ops.nms import sigmas_for

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "medium": (32**2, 96**2),
    "large": (96**2, 1e10),
}


def _dt_bbox_area(kpts: np.ndarray) -> float:
    """pycocotools loadRes: detection area from the keypoint extent."""
    x = kpts[0::3]
    y = kpts[1::3]
    x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    return float((x1 - x0) * (y1 - y0))


def compute_oks(gts: List[Dict], dts: List[Dict], sigmas: np.ndarray) -> np.ndarray:
    """OKS matrix [len(dts), len(gts)], pycocotools computeOks semantics.

    Vectorized over detections: per gt, all dts are scored in one [nd, K]
    numpy expression; identical arithmetic to the scalar form.
    """
    variances = (sigmas * 2) ** 2
    k = len(sigmas)
    nd, ng = len(dts), len(gts)
    ious = np.zeros((nd, ng))
    if nd == 0 or ng == 0:
        return ious
    d_all = np.stack([np.asarray(d["keypoints"], np.float64).reshape(-1)
                      for d in dts]).reshape(nd, k, 3)
    xd, yd = d_all[:, :, 0], d_all[:, :, 1]
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        if k1 > 0:
            dx = xd - xg
            dy = yd - yg
        else:
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
            dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
        e = (dx**2 + dy**2) / variances / (gt["area"] + np.spacing(1)) / 2
        if k1 > 0:
            e = e[:, vg > 0]
        ious[:, j] = (np.exp(-e).sum(axis=1) / e.shape[1]
                      if e.shape[1] != 0 else 0.0)
    return ious


def _evaluate_img(gts, dts, ious, area_rng, max_dets, n_thrs):
    """Per-image matching (pycocotools evaluateImg semantics)."""
    for g in gts:
        g["_ignore"] = 1 if (g.get("ignore", 0) or g["area"] < area_rng[0]
                             or g["area"] > area_rng[1]) else 0
    gt_order = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
    gts = [gts[i] for i in gt_order]
    dt_order = np.argsort([-d["score"] for d in dts], kind="mergesort")
    dts = [dts[i] for i in dt_order[:max_dets]]
    iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
    ious_s = ious[:, gt_order] if len(ious) > 0 else ious
    ious_s = ious_s[dt_order[:max_dets], :] if len(ious_s) > 0 else ious_s

    ng, nd = len(gts), len(dts)
    gtm = np.zeros((n_thrs, ng))
    dtm = np.zeros((n_thrs, nd))
    gt_ig = np.array([g["_ignore"] for g in gts])
    dt_ig = np.zeros((n_thrs, nd))

    if len(ious_s) > 0:
        for t_i, t in enumerate(IOU_THRS[:n_thrs]):
            for d_i, d in enumerate(dts):
                iou = min(t, 1 - 1e-10)
                m = -1
                for g_i in range(ng):
                    if gtm[t_i, g_i] > 0 and not iscrowd[g_i]:
                        continue
                    if m > -1 and gt_ig[m] == 0 and gt_ig[g_i] == 1:
                        break
                    if ious_s[d_i, g_i] < iou:
                        continue
                    iou = ious_s[d_i, g_i]
                    m = g_i
                if m == -1:
                    continue
                dt_ig[t_i, d_i] = gt_ig[m]
                dtm[t_i, d_i] = gts[m]["id"]
                gtm[t_i, m] = dts[d_i]["id"]

    # unmatched detections outside the area range are ignored
    a = np.array([d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts])
    if nd:
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.tile(a, (n_thrs, 1))))
    return {
        "dtMatches": dtm,
        "dtScores": np.array([d["score"] for d in dts]),
        "gtIgnore": gt_ig,
        "dtIgnore": dt_ig,
    }


def _accumulate(results: List[Optional[Dict]], n_thrs: int):
    """-> (precision [T, R], recall [T]) for one (areaRng, maxDet) setting."""
    results = [r for r in results if r is not None]
    n_r = len(REC_THRS)
    precision = -np.ones((n_thrs, n_r))
    recall = -np.ones(n_thrs)
    if not results:
        return precision, recall

    dt_scores = np.concatenate([r["dtScores"] for r in results])
    inds = np.argsort(-dt_scores, kind="mergesort")
    dtm = np.concatenate([r["dtMatches"] for r in results], axis=1)[:, inds]
    dt_ig = np.concatenate([r["dtIgnore"] for r in results], axis=1)[:, inds]
    gt_ig = np.concatenate([r["gtIgnore"] for r in results])
    npig = int(np.count_nonzero(gt_ig == 0))
    if npig == 0:
        return precision, recall

    tps = np.logical_and(dtm, np.logical_not(dt_ig))
    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dt_ig))
    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
    for t in range(n_thrs):
        tp, fp = tp_sum[t], fp_sum[t]
        rc = tp / npig
        pr = tp / (fp + tp + np.spacing(1))
        recall[t] = rc[-1] if len(rc) else 0

        pr = pr.tolist()
        for i in range(len(pr) - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds_r = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(n_r)
        for ri, pi in enumerate(inds_r):
            if pi < len(pr):
                q[ri] = pr[pi]
        precision[t] = q
    return precision, recall


class KeypointEval:
    """Evaluate keypoint detections against COCO-format ground truth.

    Args:
      gt: dict image_id -> list of gt dicts {id, keypoints (3K), area, bbox
        (xywh), iscrowd, num_keypoints}.
      dt: dict image_id -> list of dt dicts {keypoints (3K), score}.
      num_joints: 17 (COCO sigmas) or 14 (CrowdPose sigmas).
      crowd_index: optional dict image_id -> crowdIndex (CrowdPose mode).
    """

    def __init__(self, gt: Dict[int, List[Dict]], dt: Dict[int, List[Dict]],
                 num_joints: int = 17, sigmas: Optional[np.ndarray] = None,
                 crowd_index: Optional[Dict[int, float]] = None,
                 max_dets: int = 20):
        self.sigmas = sigmas if sigmas is not None else sigmas_for(num_joints)
        self.max_dets = max_dets
        self.crowd_index = crowd_index
        self.img_ids = sorted(set(gt.keys()) | set(dt.keys()))
        self.gt, self.dt = {}, {}
        uid = 1
        for i in self.img_ids:
            gl = []
            for g in gt.get(i, []):
                g = dict(g)
                g.setdefault("id", uid); uid += 1
                g["ignore"] = int(g.get("ignore", 0)) or int(g.get("num_keypoints", 1) == 0)
                gl.append(g)
            dl = []
            for d in dt.get(i, []):
                d = dict(d)
                d.setdefault("id", uid); uid += 1
                kp = np.asarray(d["keypoints"], np.float64).reshape(-1)
                d.setdefault("area", _dt_bbox_area(kp))
                dl.append(d)
            self.gt[i] = gl
            self.dt[i] = dl
        # OKS matrices are independent of area range / crowd band; compute
        # once per image and reuse across every _run (summarize_coco runs 3
        # area ranges, summarize_crowdpose 4 bands — pycocotools likewise
        # computes ious once in evaluate() before accumulate)
        self._iou_cache: Dict[int, np.ndarray] = {}

    def _ious(self, i: int) -> np.ndarray:
        out = self._iou_cache.get(i)
        if out is None:
            gts, dts = self.gt[i], self.dt[i]
            out = (compute_oks(gts, dts, self.sigmas) if gts and dts
                   else np.zeros((len(dts), len(gts))))
            self._iou_cache[i] = out
        return out

    def _run(self, area_rng: Tuple[float, float],
             img_filter=None) -> Tuple[np.ndarray, np.ndarray]:
        n_thrs = len(IOU_THRS)
        per_img = []
        for i in self.img_ids:
            if img_filter is not None and not img_filter(i):
                continue
            gts, dts = self.gt[i], self.dt[i]
            if not gts and not dts:
                per_img.append(None)
                continue
            per_img.append(_evaluate_img(gts, dts, self._ious(i), area_rng,
                                         self.max_dets, n_thrs))
        return _accumulate(per_img, n_thrs)

    @staticmethod
    def _ap(precision: np.ndarray, thr: Optional[float] = None) -> float:
        p = precision if thr is None else precision[np.where(np.isclose(IOU_THRS, thr))[0]]
        p = p[p > -1]
        return float(np.mean(p)) if p.size else -1.0

    @staticmethod
    def _ar(recall: np.ndarray, thr: Optional[float] = None) -> float:
        r = recall if thr is None else recall[np.where(np.isclose(IOU_THRS, thr))[0]]
        r = r[r > -1]
        return float(np.mean(r)) if r.size else -1.0

    def summarize_coco(self) -> List[Tuple[str, float]]:
        """The 10 standard COCO keypoint stats."""
        p_all, r_all = self._run(AREA_RNGS["all"])
        p_m, r_m = self._run(AREA_RNGS["medium"])
        p_l, r_l = self._run(AREA_RNGS["large"])
        return [
            ("AP", self._ap(p_all)),
            ("Ap .5", self._ap(p_all, 0.5)),
            ("AP .75", self._ap(p_all, 0.75)),
            ("AP (M)", self._ap(p_m)),
            ("AP (L)", self._ap(p_l)),
            ("AR", self._ar(r_all)),
            ("AR .5", self._ar(r_all, 0.5)),
            ("AR .75", self._ar(r_all, 0.75)),
            ("AR (M)", self._ar(r_m)),
            ("AR (L)", self._ar(r_l)),
        ]

    def summarize_crowdpose(self) -> List[Tuple[str, float]]:
        """CrowdPose stats: AP/.5/.75, AR/.5/.75, AP easy/medium/hard."""
        p_all, r_all = self._run(AREA_RNGS["all"])
        ci = self.crowd_index or {}

        # half-open crowdIndex bands per the crowdpose api: easy [0, 0.1),
        # medium [0.1, 0.8), hard [0.8, 1]
        def band(lo, hi, closed_hi=False):
            if closed_hi:
                return lambda i: lo <= ci.get(i, 0.0) <= hi
            return lambda i: lo <= ci.get(i, 0.0) < hi

        p_e, _ = self._run(AREA_RNGS["all"], band(0.0, 0.1))
        p_m, _ = self._run(AREA_RNGS["all"], band(0.1, 0.8))
        p_h, _ = self._run(AREA_RNGS["all"], band(0.8, 1.0, closed_hi=True))
        return [
            ("AP", self._ap(p_all)),
            ("Ap .5", self._ap(p_all, 0.5)),
            ("AP .75", self._ap(p_all, 0.75)),
            ("AR", self._ar(r_all)),
            ("AR .5", self._ar(r_all, 0.5)),
            ("AR .75", self._ar(r_all, 0.75)),
            ("AP (easy)", self._ap(p_e)),
            ("AP (medium)", self._ap(p_m)),
            ("AP (hard)", self._ap(p_h)),
        ]
