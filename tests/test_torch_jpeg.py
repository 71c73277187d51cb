"""The port's image reading and resize against OpenCV, bit for bit.

* ``data/jpeg.py::imread`` (Pillow) against ``cv2.imread(path, IMREAD_COLOR
  | IMREAD_IGNORE_ORIENTATION)``, BGR and, with ``rgb``, against
  ``cvtColor(BGR2RGB)``: the fixture's JPEGs, files written by
  ``cv2.imwrite`` at quality 50, 75 and 95 and at odd sizes, with restart
  intervals, progressive, grayscale, and 4:4:4, 4:2:2 and 4:2:0 files
  written by Pillow; an EXIF orientation is ignored. A CMYK file, a palette
  PNG and a missing file raise ``ValueError`` naming the file.
* ``data/resize.py::resize_linear`` against ``cv2.resize(img, (w, h))``
  (``INTER_LINEAR``) on uint8, at the down-scale factors of
  ``make_raw_batch`` and at exact halves (OpenCV's area path), colour and
  grayscale.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from i2rnet_tpu_torch.data.jpeg import imread
from i2rnet_tpu_torch.data.resize import resize_linear
from torch_fixture import FIXTURE, IMAGES

FLAGS = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION


def picture(rng, h, w):
    """Noise over smooth gradients and a few solid shapes (both flat and busy
    8x8 blocks for the encoder)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 127 // max(h + w - 2, 1)], -1).astype(np.int32)
    img += rng.randint(-30, 31, img.shape)
    for _ in range(3):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        img[y0:y0 + h // 3, x0:x0 + w // 4] = rng.randint(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def assert_reads_as_cv2(path):
    want = cv2.imread(str(path), FLAGS)
    got = imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(path))
    np.testing.assert_array_equal(imread(str(path), rgb=True),
                                  cv2.cvtColor(want, cv2.COLOR_BGR2RGB))


def test_fixture_images_read_as_cv2():
    paths = sorted((FIXTURE / IMAGES).glob("*.jpg"))
    assert len(paths) == 32
    for p in paths:
        assert_reads_as_cv2(p)


@pytest.mark.parametrize("hw", [(240, 320), (37, 53), (1, 1), (17, 9), (64, 64)])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_cv2_written_files_read_as_cv2(tmp_path, hw, quality):
    img = picture(np.random.RandomState(quality + hw[0]), *hw)
    path = tmp_path / "a.jpg"
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert_reads_as_cv2(path)


@pytest.mark.parametrize("option", [cv2.IMWRITE_JPEG_RST_INTERVAL, cv2.IMWRITE_JPEG_PROGRESSIVE],
                         ids=["restart_interval", "progressive"])
def test_restart_intervals_and_progressive_read_as_cv2(tmp_path, option):
    img = picture(np.random.RandomState(7), 101, 77)
    path = tmp_path / "a.jpg"
    value = 3 if option == cv2.IMWRITE_JPEG_RST_INTERVAL else 1
    assert cv2.imwrite(str(path), img, [option, value])
    data = path.read_bytes()
    marker = b"\xff\xdd" if option == cv2.IMWRITE_JPEG_RST_INTERVAL else b"\xff\xc2"
    assert marker in data  # a DRI segment / a progressive frame header was written
    assert_reads_as_cv2(path)


def test_grayscale_reads_as_three_equal_channels(tmp_path):
    gray = picture(np.random.RandomState(3), 45, 61)[..., 0]
    path = tmp_path / "g.jpg"
    assert cv2.imwrite(str(path), gray)
    assert_reads_as_cv2(path)
    got = imread(str(path))
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_pillow_written_subsamplings_read_as_cv2(tmp_path, subsampling):
    img = picture(np.random.RandomState(subsampling), 53, 70)
    path = tmp_path / "p.jpg"
    Image.fromarray(img).save(path, quality=90, subsampling=subsampling)
    assert_reads_as_cv2(path)


def test_exif_orientation_is_ignored(tmp_path):
    img = picture(np.random.RandomState(9), 40, 64)
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 degrees on display
    path = tmp_path / "o.jpg"
    Image.fromarray(img).save(path, quality=90, exif=exif.tobytes())
    assert_reads_as_cv2(path)
    assert imread(str(path)).shape == (40, 64, 3)


def test_unreadable_files_raise(tmp_path):
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(picture(np.random.RandomState(1), 16, 16)).convert("CMYK").save(cmyk)
    palette = tmp_path / "p.png"
    Image.fromarray(picture(np.random.RandomState(2), 16, 16)).convert("P").save(palette)
    garbage = tmp_path / "g.jpg"
    garbage.write_bytes(b"not a jpeg")
    for path in (cmyk, palette, garbage, tmp_path / "missing.jpg"):
        with pytest.raises(ValueError, match=path.name):
            imread(str(path))


def test_zip_member_reads_as_the_file(tmp_path):
    import zipfile

    src = sorted((FIXTURE / IMAGES).glob("*.jpg"))[0]
    archive = tmp_path / "images.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.write(src, "val2017/" + src.name)
    np.testing.assert_array_equal(imread(f"{archive}@val2017/{src.name}"),
                                  cv2.imread(str(src), FLAGS))


@pytest.mark.parametrize("hw", [(240, 320), (480, 640), (37, 53), (1000, 700), (17, 9)])
def test_resize_matches_cv2(hw):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    h, w = hw
    sizes = {(max(1, int(w * f)), max(1, int(h * f)))
             for f in (0.99, 0.9, 0.8333, 0.75, 0.6667, 0.6, 0.45, 0.33, 0.25, 0.1)}
    sizes |= {(w // 2, h // 2), (w - 1, h), (w, h - 1)}
    for size in sorted(s for s in sizes if min(s) >= 1):
        np.testing.assert_array_equal(resize_linear(img, size), cv2.resize(img, size),
                                      err_msg=str(size))
        np.testing.assert_array_equal(resize_linear(img[..., 0], size),
                                      cv2.resize(img[..., 0].copy(), size), err_msg=str(size))


def test_resize_fits_the_raster_as_make_raw_batch_does():
    """The down-scale of ``make_raw_batch``: f = min(1, max_h / h, max_w / w),
    size (int(w f), int(h f)), on COCO-sized images and rasters."""
    rng = np.random.RandomState(4)
    for (h, w), (max_h, max_w) in (((480, 640), (256, 320)), ((640, 427), (512, 512)),
                                   ((375, 500), (300, 300)), ((612, 612), (306, 306))):
        img = picture(rng, h, w)
        f = min(1.0, max_h / h, max_w / w)
        size = (int(w * f), int(h * f))
        np.testing.assert_array_equal(resize_linear(img, size), cv2.resize(img, size))
    with pytest.raises(ValueError, match="uint8"):
        resize_linear(np.zeros((4, 4), np.float32), (2, 2))
