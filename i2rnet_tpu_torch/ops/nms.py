"""OKS-NMS on the host, in numpy.

The numpy half of ``i2rnet_tpu/ops/nms.py`` (reference ``lib/nms/nms.py:
35-184``), copied: the per-dataset OKS sigmas, the candidate-by-candidate
OKS matrix, greedy and soft (Gaussian rescoring) suppression, and the
reference-API wrappers over a list of keypoint dicts that the datasets'
``evaluate`` calls. The JAX package runs its wrappers through a C++ build
when one is there (``native/nms.cpp``), with this numpy path as its
fallback; the port keeps the numpy path only. The device NMS
(``oks_nms_device``) is not ported.
"""

from __future__ import annotations

import numpy as np

COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89],
    np.float32) / 10.0
CROWDPOSE_SIGMAS = np.array(
    [.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89, .62, .79],
    np.float32) / 10.0


def sigmas_for(num_joints: int) -> np.ndarray:
    """Per-dataset OKS falloff constants (reference ``nms.py:77-81``)."""
    if num_joints == 17:
        return COCO_SIGMAS
    if num_joints == 14:
        return CROWDPOSE_SIGMAS
    # synthetic / custom skeletons: a uniform mid-range falloff
    return np.full(num_joints, 0.06, np.float32)


def np_oks_iou_matrix(kpts, areas, sigmas, in_vis_thre=None):
    """OKS of every candidate pair, [n, n] (``in_vis_thre``: average only over
    the column candidate's joints above it)."""
    kpts = np.asarray(kpts, np.float32)
    areas = np.asarray(areas, np.float32)
    variances = (np.asarray(sigmas, np.float32) * 2.0) ** 2
    xg = kpts[:, None, :, 0]
    yg = kpts[:, None, :, 1]
    xd = kpts[None, :, :, 0]
    yd = kpts[None, :, :, 1]
    d2 = (xd - xg) ** 2 + (yd - yg) ** 2
    denom = (areas[:, None] + areas[None, :]) / 2.0 + np.spacing(1)
    e = d2 / variances / denom[..., None] / 2.0
    if in_vis_thre is not None:
        mask = (kpts[None, :, :, 2] > in_vis_thre).astype(np.float32)
        cnt = mask.sum(axis=-1)
        return np.where(cnt > 0,
                        (np.exp(-e) * mask).sum(axis=-1) / np.maximum(cnt, 1.0),
                        0.0)
    return np.exp(-e).mean(axis=-1)


def _np_greedy_from_iou(iou, scores, thresh):
    """Greedy suppression; kept indices in stable score-descending order."""
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(scores), bool)
    keep = []
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(int(idx))
        suppressed |= iou[idx] > thresh
    return keep


def _np_soft_from_iou(iou, scores, thresh, max_dets):
    """Soft suppression: f32 Gaussian rescoring, first-max tie-break; picked
    indices in pick order."""
    cur = np.asarray(scores, np.float32).copy()
    picks = []
    for _ in range(max_dets):
        idx = int(np.argmax(cur))
        if not (cur[idx] > -np.inf):  # exhausted (or nan)
            break
        picks.append(idx)
        cur = (cur * np.exp(-(iou[idx] ** 2) / np.float32(thresh))).astype(np.float32)
        cur[idx] = -np.inf
        if len(picks) == len(scores):
            break
    return picks


def _db_to_arrays(kpts_db):
    scores = np.array([d["score"] for d in kpts_db], np.float32)
    kpts = np.stack([np.asarray(d["keypoints"], np.float32).reshape(-1, 3) for d in kpts_db])
    areas = np.array([d["area"] for d in kpts_db], np.float32)
    return kpts, areas, scores


def oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None, num_joints=17):
    """Reference-API OKS-NMS. Returns kept indices in score order."""
    if len(kpts_db) == 0:
        return []
    kpts, areas, scores = _db_to_arrays(kpts_db)
    if sigmas is None:
        sigmas = sigmas_for(kpts.shape[1] if num_joints is None else num_joints)
    iou = np_oks_iou_matrix(kpts, areas, sigmas, in_vis_thre=in_vis_thre)
    return _np_greedy_from_iou(iou, scores, thresh)


def soft_oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None, num_joints=17, max_dets=20):
    """Reference-API soft OKS-NMS. Returns picked indices in pick order."""
    if len(kpts_db) == 0:
        return []
    kpts, areas, scores = _db_to_arrays(kpts_db)
    if sigmas is None:
        sigmas = sigmas_for(kpts.shape[1] if num_joints is None else num_joints)
    iou = np_oks_iou_matrix(kpts, areas, sigmas, in_vis_thre=in_vis_thre)
    return _np_soft_from_iou(iou, scores, thresh, max_dets)
