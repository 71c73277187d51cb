"""Debug and demo visualisation, host-side only.

Port of ``i2rnet_tpu/utils/vis.py`` (reference ``lib/utils/vis.py`` and
``vis_demo.py``) with Pillow and numpy in place of cv2, on RGB images:

* :func:`draw_skeleton` (reference ``vis_demo.py:30-54``): the same joints,
  limbs, radii, widths and colours, drawn by Pillow's ``ImageDraw`` (the JAX
  table is BGR, as cv2 takes it; here each colour is its RGB reverse, so the
  output looks the same);
* the ``DEBUG.DEBUG`` dumps (reference ``vis.py:23-55,100-162,253-294``):
  :func:`save_batch_image_with_joints`, :func:`save_batch_heatmaps` and
  :func:`save_debug_images`. Their grids are the JAX grids' pixels in RGB:
  the same normalisation, cv2's joint disc (radius 2, thickness 2: the
  pixels within sqrt(10) of the joint), cv2's ``INTER_LINEAR`` resize
  (``data/resize.py``) and its JET colormap (:data:`JET`, cv2's table), the
  same blend; written as JPEG at cv2's default quality 95.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from i2rnet_tpu_torch.data.resize import resize_linear

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


#: cv2's ``COLORMAP_JET`` as RGB rows for the values 0-255 (``applyColorMap``'s
#: table, its BGR channels reversed)
JET = np.frombuffer(bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080"
), np.uint8).reshape(256, 3)[:, ::-1].copy()
#: cv2.circle(radius 2, thickness 2) at an integer centre: these pixels
_DISC = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4) if dy * dy + dx * dx <= 10]
#: the joint marker's colour (the JAX (255, 0, 0) in BGR)
JOINT_RGB = (0, 0, 255)
JPEG_QUALITY = 95  # cv2.imwrite's default


def _to_u8(images, normalize: bool = True) -> np.ndarray:
    """The batch scaled as the JAX dumps scale it: shifted to 0 and divided by
    its maximum over the whole batch, times 255, truncated to uint8."""
    imgs = np.asarray(images)
    if normalize:
        imgs = imgs - imgs.min()
        imgs = imgs / max(imgs.max(), 1e-6)
    return (imgs * 255).astype(np.uint8)


def _write(grid: np.ndarray, file_name: str) -> None:
    Image.fromarray(grid).save(file_name, quality=JPEG_QUALITY)


def joints_grid(images, joints, joints_vis, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """The RGB grid :func:`save_batch_image_with_joints` writes: ``images``
    ``[P, H, W, 3]`` float, ``joints`` ``[P, K, 2]`` in crop pixels,
    ``joints_vis`` ``[P, K]``; a disc per visible joint."""
    imgs = _to_u8(images)
    p, h, w = imgs.shape[:3]
    ncol = min(nrow, p)
    nrows = (p + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding), ncol * (w + padding), 3), np.uint8)
    joints, joints_vis = np.asarray(joints), np.asarray(joints_vis)
    for i in range(p):
        r, c = divmod(i, ncol)
        img = imgs[i].copy()
        for j in range(joints.shape[1]):
            if joints_vis[i, j] > 0:
                x, y = int(joints[i, j, 0]), int(joints[i, j, 1])
                for dy, dx in _DISC:
                    if 0 <= y + dy < h and 0 <= x + dx < w:
                        img[y + dy, x + dx] = JOINT_RGB
        grid[r * (h + padding):r * (h + padding) + h,
             c * (w + padding):c * (w + padding) + w] = img
    return grid


def save_batch_image_with_joints(images, joints, joints_vis, file_name: str,
                                 nrow: int = 8, padding: int = 2) -> None:
    """A grid of crops with their joints (reference ``vis.py:23-55``)."""
    _write(joints_grid(images, joints, joints_vis, nrow, padding), file_name)


def heatmaps_grid(images, heatmaps, normalize: bool = True) -> np.ndarray:
    """The RGB grid :func:`save_batch_heatmaps` writes: a row per crop, the
    crop resized to the heatmap then one JET panel per joint blended 0.7 /
    0.3 over it. ``images`` ``[P, H, W, 3]``, ``heatmaps`` ``[P, K, h, w]``."""
    imgs = _to_u8(images, normalize)
    hm = np.asarray(heatmaps)
    p, k, hh, hw = hm.shape
    grid = np.zeros((p * hh, (k + 1) * hw, 3), np.uint8)
    for i in range(p):
        resized = resize_linear(imgs[i], (hw, hh))
        grid[i * hh:(i + 1) * hh, :hw] = resized
        for j in range(k):
            m = hm[i, j]
            m = np.clip(m / max(m.max(), 1e-6) * 255, 0, 255).astype(np.uint8)
            blend = (JET[m] * 0.7 + resized * 0.3).astype(np.uint8)
            grid[i * hh:(i + 1) * hh, (j + 1) * hw:(j + 2) * hw] = blend
    return grid


def save_batch_heatmaps(images, heatmaps, file_name: str, normalize: bool = True) -> None:
    """Each crop beside its heatmaps (reference ``vis.py:100-162``)."""
    _write(heatmaps_grid(images, heatmaps, normalize), file_name)


def save_debug_images(cfg: Dict, batch, meta, target, heatmaps_pred, prefix: str) -> None:
    """The ``DEBUG.DEBUG`` dump of one batch (reference ``vis.py:253-294``):
    ``{prefix}_gt.jpg`` (``SAVE_BATCH_IMAGES_GT``), ``{prefix}_hm_gt.jpg``
    (``SAVE_HEATMAPS_GT``) and ``{prefix}_hm_pred.jpg``
    (``SAVE_HEATMAPS_PRED``). ``batch["images"]`` ``[B, N, H, W, 3]``,
    ``meta["joints"]`` ``[B, N, K, 2]`` in crop pixels, ``meta["joints_vis"]``
    ``[B, N, K, 1]``, ``target`` and ``heatmaps_pred`` ``[B, N, K, h, w]``;
    tensors or arrays."""
    debug = cfg["DEBUG"]
    if not debug["DEBUG"]:
        return
    imgs = _host(batch["images"])
    b, n = imgs.shape[:2]
    flat = imgs.reshape(b * n, *imgs.shape[2:])
    if debug.get("SAVE_BATCH_IMAGES_GT", False):
        joints = np.asarray(meta["joints"])[..., :2].reshape(b * n, -1, 2)
        vis = np.asarray(meta["joints_vis"])[..., 0].reshape(b * n, -1)
        save_batch_image_with_joints(flat, joints, vis, f"{prefix}_gt.jpg")
    for key, maps, suffix in (("SAVE_HEATMAPS_GT", target, "hm_gt"),
                              ("SAVE_HEATMAPS_PRED", heatmaps_pred, "hm_pred")):
        if debug.get(key, False):
            m = _host(maps)
            save_batch_heatmaps(flat, m.reshape(b * n, *m.shape[2:]), f"{prefix}_{suffix}.jpg")


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a float32 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
