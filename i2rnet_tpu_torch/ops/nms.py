"""OKS and box NMS: on the tensors' device in torch, and on the host.

Port of ``i2rnet_tpu/ops/nms.py`` (reference ``lib/nms/nms.py:35-184``, and
its compiled ``cpu_nms``/``gpu_nms``):

* the device functions, plain torch on the device of their inputs with the
  JAX signatures and semantics, fixed shapes over padded candidates (a
  ``valid`` mask), no host synchronisation: :func:`oks_iou_matrix`,
  :func:`greedy_nms_from_iou`, :func:`oks_nms_device`,
  :func:`soft_oks_nms_device`, :func:`box_iou_matrix`;
* the host wrappers over the reference's list of keypoint dicts that the
  datasets' ``evaluate`` calls (:func:`oks_nms`, :func:`soft_oks_nms`) and
  :func:`box_nms` over ``[M, 5]`` detections, which run the C++ library
  ``native/nms.cpp`` (``i2rnet_tpu_torch/native.py``) where no visibility
  threshold is given, as the JAX wrappers do; unlike JAX's they raise when
  the library cannot be built, rather than fall back;
* the numpy versions (``np_oks_iou_matrix``, ``np_box_iou_matrix`` and the
  greedy and soft loops), copies of the JAX package's: the wrappers' route
  with a visibility threshold, and the plain versions the tests hold the
  device functions and the library against.
"""

from __future__ import annotations

import numpy as np
import torch

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


def oks_iou_matrix(kpts, areas, sigmas, vis=None, in_vis_thre=None):
    """``[M, M]`` OKS of every candidate pair on ``kpts``' device, entry [g, d]
    the OKS of d against g (JAX ``ops/nms.py:40``); ``kpts`` [M, K, 3] (x, y,
    confidence), ``areas`` [M], ``sigmas`` [K]. With ``in_vis_thre`` the mean
    runs over the joints of the candidate d whose confidence (``vis``, else
    ``kpts[..., 2]``) is above it: the reference's filter, which masks by d
    only."""
    kpts = torch.as_tensor(kpts, dtype=torch.float32)
    dev = kpts.device
    areas = torch.as_tensor(areas, dtype=torch.float32, device=dev)
    variances = (torch.as_tensor(sigmas, dtype=torch.float32, device=dev) * 2.0) ** 2
    xg, yg = kpts[:, None, :, 0], kpts[:, None, :, 1]
    xd, yd = kpts[None, :, :, 0], kpts[None, :, :, 1]
    d2 = (xd - xg) ** 2 + (yd - yg) ** 2
    denom = (areas[:, None] + areas[None, :]) / 2.0 + float(np.spacing(1))
    e = d2 / variances / denom[..., None] / 2.0
    if in_vis_thre is None:
        return torch.exp(-e).mean(-1)
    vis = kpts[..., 2] if vis is None else torch.as_tensor(vis, dtype=torch.float32, device=dev)
    mask = (vis[None, :, :] > in_vis_thre).float()
    cnt = mask.sum(-1)
    return torch.where(cnt > 0, (torch.exp(-e) * mask).sum(-1) / cnt.clamp(min=1.0),
                       torch.zeros((), device=dev))


def greedy_nms_from_iou(iou, scores, valid, thresh):
    """Greedy hard NMS over a pairwise ``iou`` [M, M] (JAX ``ops/nms.py:78``):
    in descending score order (JAX's reversed stable ascending sort, so equal
    scores go later index first), a valid candidate is kept unless a kept one
    overlaps it by more than ``thresh``. Returns ``keep`` [M] bool, on the
    device of ``iou``, without a host synchronisation."""
    iou = torch.as_tensor(iou, dtype=torch.float32)
    dev = iou.device
    scores = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    m = scores.shape[0]
    order = torch.argsort(torch.where(valid, scores, -torch.inf), stable=True).flip(0)
    keep = torch.zeros(m, dtype=torch.bool, device=dev)
    suppressed = torch.zeros(m, dtype=torch.bool, device=dev)
    for i in range(m):
        idx = order[i]
        ok = valid[idx] & ~suppressed[idx]
        keep[idx] = ok
        suppressed = torch.where(ok, suppressed | (iou[idx] > thresh), suppressed)
    return keep


def oks_nms_device(kpts, areas, scores, valid, thresh, sigmas):
    """OKS-NMS over fixed-size padded candidates on their device (JAX
    ``ops/nms.py:109``); returns ``keep`` [M] bool."""
    return greedy_nms_from_iou(oks_iou_matrix(kpts, areas, sigmas), scores, valid, thresh)


def soft_oks_nms_device(iou, scores, valid, thresh, max_dets: int = 20):
    """Soft (Gaussian) OKS-NMS on ``iou``'s device (JAX ``ops/nms.py:116``,
    reference ``nms.py:142-181``): ``max_dets`` times pick the current
    maximum (the first of equal ones), then rescore every candidate by
    ``s * exp(-iou^2 / thresh)`` and retire the pick. Returns (``keep`` [M]
    bool, ``picks`` [max_dets] int32, -1 once no valid candidate is left)."""
    iou = torch.as_tensor(iou, dtype=torch.float32)
    dev = iou.device
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    m = valid.shape[0]
    cur = torch.where(valid, torch.as_tensor(scores, dtype=torch.float32, device=dev),
                      -torch.inf)
    keep = torch.zeros(m, dtype=torch.bool, device=dev)
    picks = torch.full((max_dets,), -1, dtype=torch.int32, device=dev)
    index = torch.arange(m, device=dev)
    for i in range(max_dets):
        idx = torch.argmax(cur)
        ok = cur[idx] > -torch.inf
        keep[idx] = ok | keep[idx]
        picks[i] = torch.where(ok, idx, -1).to(torch.int32)
        rescored = cur * torch.exp(-(iou[idx] ** 2) / thresh)
        cur = torch.where(index == idx, -torch.inf, rescored)
    return keep, picks


def box_iou_matrix(boxes):
    """``[M, 4]`` x1y1x2y2 -> ``[M, M]`` IoU on ``boxes``' device, with the +1
    area convention of reference ``nms.py:52-67`` (JAX ``ops/nms.py:143``)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    w = (torch.minimum(x2[:, None], x2[None, :]) - torch.maximum(x1[:, None], x1[None, :])
         + 1).clamp(min=0.0)
    h = (torch.minimum(y2[:, None], y2[None, :]) - torch.maximum(y1[:, None], y1[None, :])
         + 1).clamp(min=0.0)
    inter = w * h
    return inter / (areas[:, None] + areas[None, :] - inter)


def np_box_iou_matrix(boxes):
    """Numpy twin of :func:`box_iou_matrix` (+1 area convention)."""
    boxes = np.asarray(boxes, np.float32)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
    return inter / (areas[:, None] + areas[None, :] - inter)


def np_box_nms(dets, thresh):
    """The numpy greedy box NMS: kept indices in stable score-descending order."""
    dets = np.asarray(dets, np.float32)
    return _np_greedy_from_iou(np_box_iou_matrix(dets[:, :4]), dets[:, 4], thresh)


def box_nms(dets, thresh):
    """Greedy box NMS (JAX ``ops/nms.py:172``; the reference's ``nms``/
    ``cpu_nms``/``gpu_nms``): ``dets`` [M, 5] (x1, y1, x2, y2, score) ->
    kept indices in score order, through the C++ library."""
    dets = np.asarray(dets, np.float32)
    if dets.shape[0] == 0:
        return []
    from i2rnet_tpu_torch import native
    return native.box_nms(dets, thresh)


def _db_to_arrays(kpts_db):
    scores = np.array([d["score"] for d in kpts_db], np.float32)
    kpts = np.stack([np.asarray(d["keypoints"], np.float32).reshape(-1, 3) for d in kpts_db])
    areas = np.array([d["area"] for d in kpts_db], np.float32)
    return kpts, areas, scores


def oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None, num_joints=17):
    """Reference-API OKS-NMS. Returns kept indices in score order: the C++
    library's without ``in_vis_thre``, the numpy loop's with it."""
    if len(kpts_db) == 0:
        return []
    kpts, areas, scores = _db_to_arrays(kpts_db)
    if sigmas is None:
        sigmas = sigmas_for(kpts.shape[1] if num_joints is None else num_joints)
    if in_vis_thre is None:
        from i2rnet_tpu_torch import native
        return native.oks_nms(kpts, areas, scores, np.asarray(sigmas), thresh)
    iou = np_oks_iou_matrix(kpts, areas, sigmas, in_vis_thre=in_vis_thre)
    return _np_greedy_from_iou(iou, scores, thresh)


def soft_oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None, num_joints=17, max_dets=20):
    """Reference-API soft OKS-NMS. Returns picked indices in pick order: the
    C++ library's without ``in_vis_thre``, the numpy loop's with it."""
    if len(kpts_db) == 0:
        return []
    kpts, areas, scores = _db_to_arrays(kpts_db)
    if sigmas is None:
        sigmas = sigmas_for(kpts.shape[1] if num_joints is None else num_joints)
    if in_vis_thre is None:
        from i2rnet_tpu_torch import native
        return native.soft_oks_nms(kpts, areas, scores, np.asarray(sigmas), thresh, max_dets)
    iou = np_oks_iou_matrix(kpts, areas, sigmas, in_vis_thre=in_vis_thre)
    return _np_soft_from_iou(iou, scores, thresh, max_dets)
