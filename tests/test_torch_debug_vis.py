"""The ``DEBUG.DEBUG`` image dumps against the JAX package's (cv2) ones.

``utils/vis.py`` draws with numpy and writes with Pillow; the JAX module
draws and writes with cv2. On the same inputs the grids before encoding are
the JAX grids with the channels reversed (RGB for cv2's BGR), pixel for
pixel: tolerance 0 for the crops, the joint discs and the JET heatmap panels
(cv2's resize and colormap reproduced exactly). One exception, cv2's, is
stated: where a disc is cut by the left edge with its centre at x = -1, or
by the top edge with its centre at y = -3, cv2's clipped fill leaves out the
pixels of the disc's bottom row at dx = +-1, which the port paints. The JPEG
files, encoded by two libraries at quality 95, have the same size and
decode within a mean of 1.5 levels and a 99th percentile of 8 levels of
each other.
"""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from i2rnet_tpu.utils import vis as jvis
from i2rnet_tpu_torch.utils import vis

P, K, H, W, HH, HW = 5, 6, 64, 48, 16, 12


@pytest.fixture
def captured(monkeypatch):
    """What the JAX functions hand ``cv2.imwrite``: {file name: BGR grid},
    the files written too."""
    grids = {}
    write = cv2.imwrite

    def imwrite(name, img):
        grids[name] = img.copy()
        return write(name, img)

    monkeypatch.setattr(jvis.cv2, "imwrite", imwrite)
    return grids


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = (rng.randn(P, H, W, 3) * 0.8 - 0.2).astype(np.float32)
    joints = rng.uniform(-4, W + 4, (P, K, 2)).astype(np.float32)
    joints[..., 1] = rng.uniform(-4, H + 4, (P, K))
    joints[0, 0] = (0.4, 0.6)      # at the corner: the disc is cut
    joints[0, 1] = (W - 1, H - 1)
    joints[1, 0] = (-1.5, 20.0)    # cv2's clipping quirks (module docstring)
    joints[1, 1] = (20.0, -3.5)
    vis_ = (rng.rand(P, K) > 0.25).astype(np.float32)
    vis_[1, :2] = 1.0
    heat = rng.rand(P, K, HH, HW).astype(np.float32) ** 4
    heat[1, 2] = 0.0  # an empty map: the 1e-6 floor
    return images, joints, vis_, heat


def decoded_close(a, b):
    x, y = (np.asarray(Image.open(f).convert("RGB"), np.float64) for f in (a, b))
    assert x.shape == y.shape
    d = np.abs(x - y)
    assert d.mean() < 1.5 and np.percentile(d, 99) <= 8, (d.mean(), np.percentile(d, 99))


@pytest.mark.parametrize("seed", [0, 1])
def test_joints_grid_matches_jax(seed, captured, tmp_path):
    images, joints, vis_, _ = inputs(seed)
    jvis.save_batch_image_with_joints(images, joints, vis_, str(tmp_path / "jax.jpg"), nrow=3)
    ref = captured[str(tmp_path / "jax.jpg")][..., ::-1]
    got = vis.joints_grid(images, joints, vis_, nrow=3)
    assert got.shape == ref.shape == (2 * (H + 2), 3 * (W + 2), 3)
    # cv2's quirk: the bottom-row pixels it leaves out, in grid coordinates
    quirk = set()
    for i, j in zip(*np.nonzero(vis_)):
        x, y = (int(v) for v in joints[i, j])
        r, c = divmod(int(i), 3)
        for dx in ((1,) if x == -1 else ()) + ((-1, 1) if y == -3 else ()):
            if 0 <= x + dx < W and 0 <= y + 3 < H:
                quirk.add((r * (H + 2) + y + 3, c * (W + 2) + x + dx))
    differ = set(zip(*np.nonzero(np.any(got != ref, axis=-1))))
    assert differ == quirk and len(quirk) >= 3, (differ, quirk)
    for y, x in quirk:
        assert tuple(got[y, x]) == vis.JOINT_RGB
        got[y, x] = ref[y, x]
    np.testing.assert_array_equal(got, ref)
    # the markers: the pixels the discs painted, in both
    marker = np.all(got == vis.JOINT_RGB, axis=-1)
    assert marker.sum() > 0
    np.testing.assert_array_equal(marker, np.all(ref == (0, 0, 255), axis=-1))
    vis.save_batch_image_with_joints(images, joints, vis_, str(tmp_path / "port.jpg"), nrow=3)
    decoded_close(tmp_path / "port.jpg", tmp_path / "jax.jpg")


@pytest.mark.parametrize("normalize", [True, False])
def test_heatmaps_grid_matches_jax(normalize, captured, tmp_path):
    images, _, _, heat = inputs(2)
    if not normalize:
        images = np.clip(images * 0.2 + 0.5, 0, 1)
    jvis.save_batch_heatmaps(images, heat, str(tmp_path / "jax.jpg"), normalize=normalize)
    ref = captured[str(tmp_path / "jax.jpg")][..., ::-1]
    got = vis.heatmaps_grid(images, heat, normalize=normalize)
    assert got.shape == ref.shape == (P * HH, (K + 1) * HW, 3)
    np.testing.assert_array_equal(got, ref)
    vis.save_batch_heatmaps(images, heat, str(tmp_path / "port.jpg"), normalize=normalize)
    decoded_close(tmp_path / "port.jpg", tmp_path / "jax.jpg")


def test_jet_is_cv2s_table():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(vis.JET, lut[:, ::-1])


def _cfg(**flags):
    keys = ("SAVE_BATCH_IMAGES_GT", "SAVE_HEATMAPS_GT", "SAVE_HEATMAPS_PRED")
    return {"DEBUG": {"DEBUG": True, **{k: flags.get(k, True) for k in keys}}}


def test_save_debug_images_writes_the_jax_files(captured, tmp_path):
    """The same three files as JAX's ``save_debug_images`` from a batch of
    B=2 images x N=3 (the port's batch as tensors), each grid as JAX's; a
    flag off writes no file of its own, and ``DEBUG.DEBUG`` off none."""
    from i2rnet_tpu.config import default_config

    images, joints, vis_, heat = inputs(3)
    b, n = 2, 3
    imgs = np.concatenate([images, images[:1]]).reshape(b, n, H, W, 3)
    meta = {"joints": np.concatenate([joints, joints[:1]]).reshape(b, n, K, 2),
            "joints_vis": np.concatenate([vis_, vis_[:1]]).reshape(b, n, K, 1)}
    target = np.concatenate([heat, heat[:1]]).reshape(b, n, K, HH, HW)
    pred = target[:, :, ::-1] * 0.5
    jcfg = default_config()
    jcfg.DEBUG.update(DEBUG=True, SAVE_BATCH_IMAGES_GT=True, SAVE_HEATMAPS_GT=True,
                      SAVE_HEATMAPS_PRED=True)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jvis.save_debug_images(jcfg, {"images": imgs}, meta, target, pred, str(tmp_path / "jax/v"))
    vis.save_debug_images(_cfg(), {"images": torch.from_numpy(imgs)}, meta,
                          torch.from_numpy(target), torch.from_numpy(pred.copy()),
                          str(tmp_path / "port/v"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["v_gt.jpg", "v_hm_gt.jpg", "v_hm_pred.jpg"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        decoded_close(tmp_path / "port" / name, tmp_path / "jax" / name)
    flat = imgs.reshape(b * n, H, W, 3)
    np.testing.assert_array_equal(
        vis.heatmaps_grid(flat, pred.reshape(b * n, K, HH, HW)),
        captured[str(tmp_path / "jax/v_hm_pred.jpg")][..., ::-1])
    vis.save_debug_images(_cfg(SAVE_HEATMAPS_GT=False), {"images": imgs}, meta, target, pred,
                          str(tmp_path / "port/w"))
    assert not (tmp_path / "port/w_hm_gt.jpg").exists() and (tmp_path / "port/w_gt.jpg").exists()
    off = {"DEBUG": {**_cfg()["DEBUG"], "DEBUG": False}}
    vis.save_debug_images(off, {"images": imgs}, meta, target, pred, str(tmp_path / "port/x"))
    assert not list((tmp_path / "port").glob("x_*"))


def test_train_loop_dumps_every_logged_step(tmp_path):
    """``train_loop`` with ``DEBUG.DEBUG`` (the JAX trainer's dumps) writes
    each logged step's three images and trains as without it."""
    from i2rnet_tpu_torch import presets
    from i2rnet_tpu_torch.core.trainer import train_loop
    from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch

    states = {}
    for debug in (False, True):
        cfg = presets.tiny_test_config(5)
        cfg.update(PRINT_FREQ=1, DEBUG=_cfg()["DEBUG"] if debug else {"DEBUG": False})
        raw = synthetic_raw_batch(cfg, [3, 2], np.random.RandomState(5), n_max=3,
                                  raw_hw=(96, 128))
        states[debug] = train_loop(cfg, str(tmp_path / str(debug)), lambda epoch: [raw, raw],
                                   max_epochs=1, device="cpu").model.state_dict()
    names = sorted(p.name for p in (tmp_path / "True" / "debug").iterdir())
    assert names == [f"train_0_{i}_{kind}.jpg" for i in (0, 1) for kind in ("gt", "hm_gt",
                                                                          "hm_pred")]
    assert Image.open(tmp_path / "True" / "debug" / names[1]).size == (12 * 6, 2 * 3 * 16)
    assert not (tmp_path / "False" / "debug").exists()
    for k, v in states[False].items():
        assert torch.equal(states[True][k], v), k
