"""The port's JPEG codec (iv_slam_tpu_torch/io/jpeg.py) against cv2 and PIL.

Bit-exact, every case: files written by cv2 (grey and 4:2:0 colour at
qualities 50, 80 and 95, with and without a restart interval, odd sizes)
decode in "gray" equal to cv2's IMREAD_GRAYSCALE, in "bgr" equal to
IMREAD_COLOR and in "unchanged" equal to PIL (imageio's reader); 4:1:1,
4:2:2, 4:4:0 and 4:4:4 files and a PIL-written file with an Exif segment
too. The encoder's bytes equal cv2.imencode's at the same quality, so
cv2's decode of them equals its decode of its own. The C entropy coder
(csrc/jpeg_huffman.c) equals its plain Python version, decoding and
encoding. Progressive and arithmetic-coded files raise ValueError naming
the mode; io/datasets.py reads .jpg files by their signature.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from iv_slam_tpu_torch.io import datasets, jpeg
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _natural(h, w, c, seed=0):
    """A smooth textured image with noise (an image JPEG is made for)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(x / 7.0) * np.cos(y / 11.0) + rng.normal(0, 12, (h, w))
    if c == 1:
        return np.clip(base, 0, 255).astype(np.uint8)
    return np.clip(np.stack([base, base[::-1] * 0.8 + 20, 255 - base], -1), 0,
                   255).astype(np.uint8)


CASES = [(h, w, c, q) for (h, w) in ((37, 53), (64, 64), (17, 9)) for c in (1, 3)
         for q in (50, 80, 95)]


@pytest.mark.parametrize("h,w,c,q", CASES)
def test_decode_and_encode_equal_cv2(h, w, c, q):
    img = _natural(h, w, c, seed=h + c + q)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
    data = buf.tobytes()
    np.testing.assert_array_equal(jpeg.decode(data, "gray"),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(jpeg.decode(data, "bgr"), cv2.imdecode(buf, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(jpeg.decode(data, "unchanged"),
                                  np.asarray(Image.open(io.BytesIO(data))))
    assert jpeg.encode(img, q) == data


@pytest.mark.parametrize("c", [1, 3])
def test_restart_markers(c):
    img = _natural(45, 70, c, seed=3)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    assert b"\xff\xdd" in buf.tobytes() and b"\xff\xd0" in buf.tobytes()
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes(), "gray"),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes(), "bgr"),
                                  cv2.imdecode(buf, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("factor", ["411", "422", "440", "444"])
def test_sampling_factors(factor):
    img = _natural(45, 67, 3, seed=5)
    sf = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf])
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes(), "bgr"),
                                  cv2.imdecode(buf, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes(), "gray"),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def test_pil_file_with_exif():
    img = _natural(40, 52, 3, seed=6)
    b = io.BytesIO()
    exif = Image.Exif()
    exif[0x010F] = "iv-slam"
    Image.fromarray(img).save(b, "JPEG", quality=70, subsampling=1, exif=exif.tobytes())
    data = b.getvalue()
    np.testing.assert_array_equal(jpeg.decode(data, "unchanged"),
                                  np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("c", [1, 3])
def test_c_coder_equals_plain(c):
    img = _natural(29, 41, c, seed=7)
    data = jpeg.encode(img, 75, coder="c")
    assert jpeg.encode(img, 75, coder="plain") == data
    for mode in ("gray", "bgr", "unchanged"):
        np.testing.assert_array_equal(jpeg.decode(data, mode, coder="plain"),
                                      jpeg.decode(data, mode, coder="c"))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes(), "bgr", coder="plain"),
                                  jpeg.decode(buf.tobytes(), "bgr", coder="c"))


def test_unsupported_modes_raise():
    img = _natural(32, 32, 3, seed=8)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode(buf.tobytes(), "bgr")
    data = bytearray(jpeg.encode(img, 80))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9                      # the frame marker of arithmetic coding
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode(bytes(data), "bgr")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG\r\n\x1a\n", "gray")


def test_datasets_read_jpeg_by_signature(tmp_path):
    img = _natural(33, 47, 3, seed=9)
    path = str(tmp_path / "000000.jpg")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(datasets.load_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(datasets.read_image(path),
                                  np.asarray(Image.open(path)))
    jpeg.write_jpeg(str(tmp_path / "port.jpg"), img)
    assert (tmp_path / "port.jpg").read_bytes() == open(path, "rb").read()
