"""OpenCV's ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) on uint8 images, in numpy.

The host batcher shrinks an image that does not fit the static raster
(``i2rnet_tpu/data/dataset.py:264-266``). This reproduces OpenCV's uint8
bilinear path bit for bit (``imgproc/src/resize.cpp``):

* source coordinate of output pixel ``d``: ``float((d + 0.5) * scale - 0.5)``
  with ``scale = 1 / (dst / src)`` in double; its floor and fraction in
  float;
* columns: a fraction below the first pixel or a pixel at or past the last
  clamps to that pixel with weight 0; rows: the two source rows clamp to the
  image, the weights stay;
* weights rounded to 11-bit fixed point (``saturate_cast<short>(w * 2048)``,
  each of the pair on its own);
* the horizontal pass sums in int32; the vertical pass is
  ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``;
* a shrink by exactly 2 on both axes takes OpenCV's area path instead: the
  rounded mean of each 2x2 block.
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, clamp_fraction: bool):
    """(first tap, second tap, their fixed-point weights) of each output index."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_fraction:
        low = s < 0
        f[low], s[low] = 0.0, 0
        high = s >= src - 1
        f[high], s[high] = 0.0, src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size)`` for a uint8 ``[H, W]`` or ``[H, W, C]``
    image; ``size`` is ``(width, height)``."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8, got {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_linear: empty output size {size}")
    if (dw, dh) == (sw, sh):
        return img.copy()
    x = img.astype(np.int64)
    if sw == 2 * dw and sh == 2 * dh:
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    x0, x1, a0, a1 = _taps(sw, dw, clamp_fraction=True)
    y0, y1, b0, b1 = _taps(sh, dh, clamp_fraction=False)
    wshape = (dw,) + (1,) * (img.ndim - 2)
    rows = x[:, x0] * a0.reshape(wshape) + x[:, x1] * a1.reshape(wshape)  # [H, dw, ...]
    bshape = (dh,) + (1,) * (img.ndim - 1)
    out = (((b0.reshape(bshape) * (rows[y0] >> 4)) >> 16)
           + ((b1.reshape(bshape) * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
