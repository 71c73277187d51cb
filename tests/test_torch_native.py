"""The port's native host NMS (``i2rnet_tpu_torch/native.py``, ``native/nms.cpp``).

The library is built from the checkout's source into ``i2rnet_tpu_torch/
_build/`` at first use and bound by ctypes. Its three entry points are held
against the port's numpy versions and the JAX package's device functions on
the same seeded candidates (the kept indices and pick orders exactly), the
host wrappers ``oks_nms``/``soft_oks_nms``/``box_nms`` are shown to route
through it, and a build that cannot run raises (no fallback, unlike the JAX
binding).
"""

import numpy as np
import pytest
import torch

from i2rnet_tpu.ops import nms as jnms
from i2rnet_tpu_torch import native
from i2rnet_tpu_torch.ops import nms
from test_torch_nms_device import candidates

torch.set_num_threads(2)


def _db(kpts, areas, scores):
    return [{"keypoints": kpts[i].reshape(-1), "score": float(scores[i]), "area": float(areas[i])}
            for i in range(len(scores))]


def test_library_builds_from_the_source_and_loads():
    lib = native.library()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE.name == "nms.cpp" and path.name.startswith("libi2rnms_")
    assert all(hasattr(lib, name) for name in native.SIGNATURES)


@pytest.mark.parametrize("thresh", [0.3, 0.6, 0.9])
def test_oks_nms_matches_numpy_and_jax(rng, thresh):
    kpts, areas, scores, _ = candidates(rng)
    got = native.oks_nms(kpts, areas, scores, nms.COCO_SIGMAS, thresh)
    iou = nms.np_oks_iou_matrix(kpts, areas, nms.COCO_SIGMAS)
    assert got == nms._np_greedy_from_iou(iou, scores, thresh)
    keep = np.asarray(jnms.oks_nms_device(kpts, areas, scores, np.ones(len(scores), bool),
                                          thresh, nms.COCO_SIGMAS))
    assert set(got) == set(np.flatnonzero(keep)) and 0 < len(got) < len(scores)


@pytest.mark.parametrize("max_dets", [5, 20, 30])
def test_soft_oks_nms_matches_numpy_and_jax(rng, max_dets):
    kpts, areas, scores, _ = candidates(rng)
    before = scores.copy()
    got = native.soft_oks_nms(kpts, areas, scores, nms.COCO_SIGMAS, 0.5, max_dets)
    np.testing.assert_array_equal(scores, before)  # the library rescored a copy
    iou = nms.np_oks_iou_matrix(kpts, areas, nms.COCO_SIGMAS)
    assert got == nms._np_soft_from_iou(iou, scores, 0.5, max_dets)
    _, picks = jnms.soft_oks_nms_device(iou, scores, np.ones(len(scores), bool), 0.5,
                                        max_dets=max_dets)
    picks = np.asarray(picks)
    assert got == list(picks[picks >= 0])


def test_box_nms_matches_numpy_and_jax(rng):
    xy = rng.rand(40, 2) * 100
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (40, 2))], 1)
    dets = np.concatenate([boxes, rng.rand(40, 1)], 1).astype(np.float32)
    got = native.box_nms(dets, 0.3)
    assert got == nms.np_box_nms(dets, 0.3) == nms.box_nms(dets, 0.3)
    assert got == jnms.box_nms(dets, 0.3) and 0 < len(got) < 40
    assert nms.box_nms(np.zeros((0, 5), np.float32), 0.3) == []


def test_host_wrappers_route_through_the_library(rng, monkeypatch):
    """Without a visibility threshold ``oks_nms`` and ``soft_oks_nms`` return
    the library's answer; with one, the numpy loop's (the library has no
    filter), as the JAX wrappers route."""
    kpts, areas, scores, _ = candidates(rng)
    db = _db(kpts, areas, scores)
    calls = []
    for name in ("oks_nms", "soft_oks_nms"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, real=real, name=name, **k: calls.append(name) or real(*a, **k))
    assert nms.oks_nms(db, 0.5) == jnms.oks_nms(db, 0.5)
    assert nms.soft_oks_nms(db, 0.5) == jnms.soft_oks_nms(db, 0.5)
    assert calls == ["oks_nms", "soft_oks_nms"]
    assert nms.oks_nms(db, 0.5, in_vis_thre=0.2) == jnms.oks_nms(db, 0.5, in_vis_thre=0.2)
    assert calls == ["oks_nms", "soft_oks_nms"]


def test_failed_build_raises(monkeypatch, tmp_path):
    """No g++ -> the build raises, and a compiler that fails raises with its
    output; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()
    bad = tmp_path / "g++"
    bad.write_text("#!/bin/sh\necho broken compiler >&2\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken compiler"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        native.build()
