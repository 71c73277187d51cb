"""Image files read as ``cv2.imread(path, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)`` reads them.

The host data path reads its JPEGs with OpenCV (``i2rnet_tpu/data/
dataset.py:219,223``). The port decodes them with Pillow, whose libjpeg-turbo
build decodes baseline and progressive JPEGs to the same bytes as OpenCV's
(the integer "islow" IDCT, fancy upsampling, libjpeg's YCbCr->RGB): held bit
for bit against ``cv2.imread`` by ``tests/test_torch_jpeg.py``. As
``IMREAD_COLOR`` does, a grayscale file comes back as three equal channels,
and the EXIF orientation is ignored (Pillow applies none unless asked).
What Pillow would decode to other bytes than OpenCV (CMYK, 16-bit or
palette images) raises ``ValueError`` naming the file; nothing falls back.

An ``archive.zip@inner/path`` spec (``DATASET.DATA_FORMAT`` zip, reference
``lib/utils/zipreader.py``) is read from the archive.
"""

from __future__ import annotations

import io
import os
import zipfile

import numpy as np

#: Pillow modes whose ``convert("RGB")`` gives OpenCV's bytes: libjpeg's own
#: YCbCr->RGB (mode RGB) and grayscale replicated to three channels (mode L)
_MODES = ("RGB", "L")


def _read_bytes(path: str) -> bytes:
    if "@" in path:
        archive, inner = path.split("@", 1)
        with zipfile.ZipFile(archive) as zf:
            return zf.read(inner.lstrip(os.sep))
    with open(path, "rb") as f:
        return f.read()


def imread(path: str, rgb: bool = False) -> np.ndarray:
    """The image at ``path`` as uint8 ``[H, W, 3]``: BGR as ``cv2.imread``
    returns it, or RGB (``cv2.cvtColor(img, COLOR_BGR2RGB)``) when ``rgb``."""
    from PIL import Image

    try:
        data = _read_bytes(path)
    except OSError as e:
        raise ValueError(f"fail to read {path}: {e}") from e
    try:
        with Image.open(io.BytesIO(data)) as im:
            if im.mode not in _MODES:
                raise ValueError(f"fail to read {path}: {im.format} mode {im.mode} "
                                 f"is not decoded as cv2.imread decodes it")
            img = np.asarray(im.convert("RGB"))
    except (OSError, Image.DecompressionBombError) as e:  # Pillow's "cannot identify"
        raise ValueError(f"fail to read {path}: {e}") from e
    return np.ascontiguousarray(img if rgb else img[:, :, ::-1])
