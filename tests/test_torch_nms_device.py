"""The device NMS of ``ops/nms.py`` vs the JAX device functions and the numpy versions.

``oks_iou_matrix``, ``greedy_nms_from_iou``, ``oks_nms_device``,
``soft_oks_nms_device`` and ``box_iou_matrix`` run in torch on the CPU here
(on the card in ``chip_smoke.py`` phase 56) on seeded candidates with padded
slots, score ties and the visibility filter, against the JAX package's
functions and the port's numpy versions on the same arrays. The matrices
agree within 1e-6 (f32 exp and sums in two orders); the kept sets and the
pick orders exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.ops import nms as jnms
from i2rnet_tpu_torch.ops import nms

torch.set_num_threads(2)


def candidates(rng, m=24, k=17, clusters=5):
    """Keypoints around a few centres (so that OKS overlaps exist), areas,
    scores with ties, and a valid mask with padded slots."""
    centres = rng.rand(clusters, k, 2) * 200
    owner = rng.randint(0, clusters, m)
    xy = centres[owner] + rng.randn(m, k, 2) * rng.choice([1.0, 6.0, 30.0], (m, 1, 1))
    conf = rng.rand(m, k, 1)
    kpts = np.concatenate([xy, conf], -1).astype(np.float32)
    areas = rng.uniform(500, 5000, m).astype(np.float32)
    scores = rng.rand(m).astype(np.float32)
    scores[3] = scores[7] = scores[11]  # ties
    valid = np.ones(m, bool)
    valid[[5, 17]] = False
    return kpts, areas, scores, valid


@pytest.mark.parametrize("vis", [None, 0.4])
def test_oks_iou_matrix_matches_jax_and_numpy(rng, vis):
    kpts, areas, _, _ = candidates(rng)
    got = nms.oks_iou_matrix(torch.from_numpy(kpts), areas, nms.COCO_SIGMAS,
                             in_vis_thre=vis).numpy()
    ref = np.asarray(jnms.oks_iou_matrix(kpts, areas, nms.COCO_SIGMAS, in_vis_thre=vis))
    plain = nms.np_oks_iou_matrix(kpts, areas, nms.COCO_SIGMAS, in_vis_thre=vis)
    assert got.shape == (24, 24) and (got > 0.5).sum() > 24
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got, plain, atol=1e-6)


@pytest.mark.parametrize("thresh", [0.3, 0.6, 0.9])
def test_oks_nms_device_matches_jax_and_numpy(rng, thresh):
    kpts, areas, scores, valid = candidates(rng)
    iou = nms.np_oks_iou_matrix(kpts, areas, nms.COCO_SIGMAS)
    keep = nms.oks_nms_device(torch.from_numpy(kpts), torch.from_numpy(areas),
                              torch.from_numpy(scores), torch.from_numpy(valid), thresh,
                              nms.COCO_SIGMAS)
    assert keep.dtype == torch.bool
    jkeep = np.asarray(jnms.oks_nms_device(kpts, areas, scores, valid, thresh, nms.COCO_SIGMAS))
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    # the numpy loop over the valid candidates keeps the same set
    idx = np.flatnonzero(valid)
    kept = nms._np_greedy_from_iou(iou[np.ix_(idx, idx)], scores[idx], thresh)
    assert set(idx[kept]) == set(np.flatnonzero(keep.numpy()))
    assert 0 < keep.sum() < valid.sum()
    # the greedy step alone on the same matrix
    np.testing.assert_array_equal(
        nms.greedy_nms_from_iou(torch.from_numpy(iou), scores, valid, thresh).numpy(),
        np.asarray(jnms.greedy_nms_from_iou(jnp.asarray(iou), scores, valid, thresh)))


@pytest.mark.parametrize("max_dets", [5, 20, 30])
def test_soft_oks_nms_device_matches_jax_and_numpy(rng, max_dets):
    kpts, areas, scores, valid = candidates(rng)
    iou = nms.np_oks_iou_matrix(kpts, areas, nms.COCO_SIGMAS)
    keep, picks = nms.soft_oks_nms_device(torch.from_numpy(iou), torch.from_numpy(scores),
                                          torch.from_numpy(valid), 0.5, max_dets)
    jkeep, jpicks = jnms.soft_oks_nms_device(jnp.asarray(iou), scores, valid, 0.5,
                                             max_dets=max_dets)
    assert picks.dtype == torch.int32 and tuple(picks.shape) == (max_dets,)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(picks.numpy(), np.asarray(jpicks))
    idx = np.flatnonzero(valid)
    plain = nms._np_soft_from_iou(iou[np.ix_(idx, idx)], scores[idx], 0.5, max_dets)
    got = picks.numpy()
    assert list(got[got >= 0]) == list(idx[plain])
    assert (got < 0).sum() == max(0, max_dets - valid.sum())


def test_box_iou_matrix_and_greedy_match_jax_and_numpy(rng):
    xy = rng.rand(30, 2) * 100
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (30, 2))], 1).astype(np.float32)
    scores = rng.rand(30).astype(np.float32)
    got = nms.box_iou_matrix(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnms.box_iou_matrix(boxes)), atol=1e-6)
    np.testing.assert_allclose(got, nms.np_box_iou_matrix(boxes), atol=1e-6)
    valid = np.ones(30, bool)
    keep = nms.greedy_nms_from_iou(torch.from_numpy(got), scores, valid, 0.3).numpy()
    dets = np.concatenate([boxes, scores[:, None]], 1)
    assert set(np.flatnonzero(keep)) == set(nms.np_box_nms(dets, 0.3))
    assert set(jnms.box_nms(dets, 0.3)) == set(nms.np_box_nms(dets, 0.3))


def test_device_functions_stay_on_their_device(rng):
    """Every output on the inputs' device (here the CPU; the card in
    ``chip_smoke.py``), the meta device included: no host round trip."""
    kpts, areas, scores, valid = candidates(rng)
    meta = torch.empty(6, 17, 3, device="meta")
    assert nms.oks_iou_matrix(meta, torch.empty(6, device="meta"),
                              nms.COCO_SIGMAS).device.type == "meta"
    keep = nms.oks_nms_device(torch.from_numpy(kpts), areas, scores, valid, 0.5, nms.COCO_SIGMAS)
    assert keep.device.type == "cpu"
