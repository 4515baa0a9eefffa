"""Port parity: the dataset I/O of iv_slam_tpu_torch (io/png.py, pfm.py,
datasets.py, rectify.py, prefetch.py, geometry/camera.undistort_points,
utils/profiling.StageTimer) against the JAX package's on the same inputs.

Tolerances: every decoded image, loader field, rectification map (against
the JAX package's NumPy formula), remapped image, prefetched frame and
timer report is exact. The JAX package's ``load_gray`` is cv2's
IMREAD_GRAYSCALE here (cv2 is installed), colour images included: the
port reproduces libpng's fixed-point conversion exactly. Against
cv2.initUndistortRectifyMap the maps agree within 2e-3 px (another formula
order in float64, then float32 rounding of coordinates up to ~750 px).
undistort_points: float32, the same operation order as the JAX package's
op-by-op evaluation, within 1e-3 px.
"""

import os
import struct
import sys
import zlib

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
import torch
from PIL import Image

from iv_slam_tpu.config import _parse_opencv_yaml as j_parse_yaml
from iv_slam_tpu.geometry import camera as jcam
from iv_slam_tpu.io import datasets as jds
from iv_slam_tpu.io import pfm as jpfm
from iv_slam_tpu.io import prefetch as jpre
from iv_slam_tpu.io import rectify as jrect
from iv_slam_tpu.utils import profiling as jprof
from iv_slam_tpu_torch.config import _parse_opencv_yaml
from iv_slam_tpu_torch.geometry import camera
from iv_slam_tpu_torch.io import datasets, pfm, png, prefetch, rectify
from iv_slam_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC = os.path.join(REPO, "settings", "EuRoC_stereo.yaml")


def _image(rng, kind, h=37, w=53):
    shape, dtype = {"g8": ((h, w), np.uint8), "g16": ((h, w), np.uint16),
                    "ga": ((h, w, 2), np.uint8), "rgb": ((h, w, 3), np.uint8),
                    "rgba": ((h, w, 4), np.uint8)}[kind]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    if kind in ("rgb", "rgba"):
        img[::7, ::5, 1:3] = img[::7, ::5, :1]   # grey pixels pass through libpng as is
    return img


def _check_read(path):
    """The port's reads of `path` against imageio (unchanged) and the JAX
    package's load_gray (cv2)."""
    got, want = png.read_png(path), iio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)
    np.testing.assert_array_equal(png.read_png(path, "gray"), jds.load_gray(path),
                                  err_msg=path)
    np.testing.assert_array_equal(datasets.load_gray(path), jds.load_gray(path))


@pytest.mark.parametrize("ft", range(5))
@pytest.mark.parametrize("kind", ["g8", "g16", "ga", "rgb", "rgba"])
def test_png_written_by_port(tmp_path, kind, ft):
    """The port's writer with one filter type on every row, read back by
    the port, imageio and cv2."""
    img = _image(np.random.default_rng(ft), kind)
    path = str(tmp_path / "x.png")
    png.write_png(path, img, filter_type=ft)
    with open(path, "rb") as f:
        data = f.read()
    idat = b"".join(b for t, b in png._chunks(data, path) if t == b"IDAT")
    stride = img.nbytes // img.shape[0]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(img.shape[0], stride + 1)
    assert set(rows[:, 0].tolist()) == {ft}
    np.testing.assert_array_equal(png.read_png(path), img)
    _check_read(path)


@pytest.mark.parametrize("kind", ["g8", "g16", "rgb", "rgba", "rgb16", "rgba16"])
def test_png_written_by_cv2(tmp_path, kind):
    """cv2's files (libpng's adaptive filters; 16-bit colour included)."""
    rng = np.random.default_rng(1)
    if kind.endswith("16"):
        img = rng.integers(0, 65536, (29, 41, 3 if kind == "rgb16" else 4), dtype=np.uint16)
    else:
        img = _image(rng, kind, 29, 41)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]])
    _check_read(path)


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_png_palette(tmp_path, bits, transparent):
    """Palette images, with and without a tRNS chunk (alpha for the first
    palette entries): imageio and cv2's grey both ignore it."""
    rgb = _image(np.random.default_rng(bits), "rgb")
    path = str(tmp_path / "p.png")
    extra = dict(transparency=bytes([0, 128, 255][:2 ** bits])) if transparent else {}
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=2 ** bits).save(
        path, bits=bits, **extra)
    with open(path, "rb") as f:
        assert (b"tRNS" in f.read()) == transparent
    _check_read(path)


def test_png_errors(tmp_path):
    path = str(tmp_path / "i.png")
    png.write_png(path, _image(np.random.default_rng(0), "g8"))
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[28] = 1    # IHDR's interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="ends early"):   # Adam7 needs more rows
        png.read_png(path)
    data[24:26] = bytes([16, 3])    # a 16-bit palette, which the format does not define
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    (tmp_path / "d.png").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="bit depth 16, colour type 3"):
        png.read_png(str(tmp_path / "d.png"))
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "n.png"))
    with pytest.raises(FileNotFoundError):
        datasets.load_gray(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError, match="filter type 5"):
        png.unfilter(np.array([[5, 1, 2]], np.uint8), 1)


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _gama(g):
    return _chunk(b"gAMA", struct.pack(">I", g))


SRGB = _chunk(b"sRGB", b"\x00")


def _png_bytes(samples, ctype, depth, interlace=0, before=b"", plte=None, ft=4, after=b""):
    """A PNG of (h, w, c) `samples` written by hand: chunks `before` ahead of
    PLTE and IDAT and `after` behind IDAT, Adam7 passes (an empty pass
    writes nothing) when `interlace`, every row under filter `ft`."""
    h, w, ch = samples.shape
    parts = []
    for x0, y0, dx, dy in png.ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            px = np.ascontiguousarray(sub.astype(">u2")).view(np.uint8).reshape(sub.shape[0], -1)
        else:
            v = sub.reshape(sub.shape[0], -1)
            bits = (v[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            px = np.packbits(bits.astype(np.uint8).reshape(v.shape[0], -1), axis=1)
        rows = png._filter(px, ft, max(1, ch * depth // 8))
        parts.append(np.concatenate([np.full((px.shape[0], 1), ft, np.uint8), rows], 1))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = b"".join(p.tobytes() for p in parts)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + before
            + (b"" if plte is None else _chunk(b"PLTE", plte.tobytes()))
            + _chunk(b"IDAT", zlib.compress(body)) + after + _chunk(b"IEND", b""))


def _samples(rng, ctype, depth, h=40, w=60):
    """Random samples of a colour type and depth, some colour pixels grey;
    with a palette (colour type 3) of 2**depth random entries."""
    ch = png.CHANNELS[ctype]
    img = rng.integers(0, 1 << depth, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    if ch >= 3:
        img[::7, ::5, 1:3] = img[::7, ::5, :1]
    plte = None
    if ctype == 3:
        plte = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
        plte[::4, 1:] = plte[::4, :1]
    return img, plte


def _check_bytes(tmp_path, data):
    """The port's two modes on the file `data` against imageio and cv2."""
    path = str(tmp_path / "c.png")
    with open(path, "wb") as f:
        f.write(data)
    _check_read(path)
    return path


FILE_GAMMAS = {"none": b"", "gAMA45455": _gama(45455), "gAMA94000": _gama(94000),
               "gAMA96000": _gama(96000), "gAMA100000": _gama(100000),
               "gAMA220000": _gama(220000), "sRGB": SRGB}


@pytest.mark.parametrize("chunk", list(FILE_GAMMAS))
@pytest.mark.parametrize("ctype,depth", [(2, 8), (2, 16), (3, 8), (6, 8), (6, 16)])
def test_png_gamma_gray(tmp_path, ctype, depth, chunk):
    """Colour files with a file gamma or none: the grey equals cv2's
    IMREAD_GRAYSCALE exactly (libpng converts in linear light when the
    gamma is significant: 0.05 or more from 1.0), the unchanged image
    imageio's (which ignores the gamma)."""
    img, plte = _samples(np.random.default_rng(ctype * 100 + depth), ctype, depth)
    path = _check_bytes(tmp_path, _png_bytes(img, ctype, depth, before=FILE_GAMMAS[chunk],
                                             plte=plte))
    plain = png.decode_png(_png_bytes(img, ctype, depth, plte=plte), "gray")
    moved = int((png.read_png(path, "gray") != plain).sum())
    if chunk in ("gAMA45455", "gAMA94000", "gAMA220000", "sRGB"):
        assert moved > img.shape[0] * img.shape[1] // 2, moved
    else:
        assert moved == 0, moved


def _icc_profile():
    from PIL import ImageCms

    prof = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    return _chunk(b"iCCP", b"sRGB\x00\x00" + zlib.compress(prof))


def _chrm(*xy):
    return _chunk(b"cHRM", b"".join(struct.pack(">I", round(v * 100000)) for v in xy))


CHUNK_RULES = {
    # sRGB wins over gAMA, whichever comes first
    "sRGB_then_gAMA1.0": (SRGB + _gama(100000), b"", 45455),
    "gAMA1.0_then_sRGB": (_gama(100000) + SRGB, b"", 45455),
    # the first gAMA wins; one of 2**31 or more is not read, and one whose
    # reciprocal leaves 32 bits (1) is libpng's edge case
    "gAMA_twice": (_gama(100000) + _gama(45455), b"", 0),
    "gAMA_2**31": (_gama(2 ** 31), b"", 0),
    "gAMA_1": (_gama(1), b"", 1),
    # gAMA and sRGB count only ahead of PLTE and IDAT
    "gAMA_after_IDAT": (b"", _gama(45455), 0),
    "sRGB_after_IDAT": (b"", SRGB, 0),
    # cHRM, iCCP and cICP leave the grey alone
    "cHRM": (_chrm(0.3457, 0.3585, 0.7347, 0.2653, 0.1596, 0.8404, 0.0366, 0.0001), b"", 0),
    "iCCP": ("icc", b"", 0),
    "cICP": (_chunk(b"cICP", bytes([1, 8, 0, 1])), b"", 0),
    "gAMA_and_cICP": (_gama(45455) + _chunk(b"cICP", bytes([1, 8, 0, 1])), b"", 45455),
    # 16-bit tables keep the top 16 - max(sBIT) bits (at most 11, at least 8)
    "sBIT10": (_chunk(b"sBIT", bytes([10, 9, 7])) + _gama(45455), b"", 45455),
    "sBIT4": (_chunk(b"sBIT", bytes([4, 4, 4])) + _gama(45455), b"", 45455),
}


@pytest.mark.parametrize("rule", list(CHUNK_RULES))
def test_png_gamma_chunk_rules(tmp_path, rule):
    """Which chunk sets the file gamma, as cv2 (libpng) reads it: 16-bit
    RGB, grey through the port equal to cv2's; the gamma it implies."""
    before, after, gamma = CHUNK_RULES[rule]
    before = _icc_profile() if before == "icc" else before
    img, _ = _samples(np.random.default_rng(7), 2, 16)
    path = _check_bytes(tmp_path, _png_bytes(img, 2, 16, before=before, after=after))
    bits = {"sBIT10": 10, "sBIT4": 4}.get(rule, 0)
    want = (png._to_gray(img, 16, gamma, bits) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(png.read_png(path, "gray"), want)


DEPTHS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
          (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("hw", [(3, 5), (13, 18)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("ctype,depth", DEPTHS)
def test_png_adam7(tmp_path, ctype, depth, hw):
    """Adam7-interlaced files (written by hand: neither cv2 nor PIL writes
    them) of every colour type and depth, at 3x5 (several passes empty) and
    13x18: equal to cv2's grey and imageio's image, and to the same image
    not interlaced."""
    img, plte = _samples(np.random.default_rng(depth * 10 + ctype), ctype, depth, *hw)
    before = _gama(45455) if ctype in (2, 3, 6) else b""
    path = _check_bytes(tmp_path, _png_bytes(img, ctype, depth, 1, before, plte))
    flat = _png_bytes(img, ctype, depth, 0, before, plte, ft=1)
    for mode in ("gray", "unchanged"):
        np.testing.assert_array_equal(png.read_png(path, mode), png.decode_png(flat, mode))


@pytest.mark.parametrize("chunk", ["none", "gAMA45455"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_sub_byte_gray(tmp_path, depth, chunk):
    """1-, 2- and 4-bit grey: cv2 scales to 8 bits (x255, x85, x17, as
    libpng's expand_gray_1_2_4_to_8), imageio gives bool for 1 bit and the
    same scaled uint8 for 2 and 4; a gamma changes neither."""
    img, _ = _samples(np.random.default_rng(depth), 0, depth, 21, 29)
    path = _check_bytes(tmp_path, _png_bytes(img, 0, depth, before=FILE_GAMMAS[chunk]))
    np.testing.assert_array_equal(png.read_png(path, "gray"),
                                  img[..., 0] * (255 // ((1 << depth) - 1)))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_matches_plain(bpp):
    """The compiled row unfilter bit-equal to its NumPy version on random
    rows, each with a random filter type."""
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (23, 1 + 17 * bpp), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, 23)
    rows[:5, 0] = [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(png.unfilter(rows, bpp), png.unfilter_plain(rows, bpp))


@pytest.mark.parametrize("shape", [(7, 9), (5, 6, 3)])
def test_pfm_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    pfm.write_pfm(str(tmp_path / "a.pfm"), img)
    np.testing.assert_array_equal(jpfm.read_pfm(str(tmp_path / "a.pfm")), img)
    jpfm.write_pfm(str(tmp_path / "b.pfm"), img)
    np.testing.assert_array_equal(pfm.read_pfm(str(tmp_path / "b.pfm")), img)
    assert datasets.load_gt_depth_pfm(str(tmp_path / "missing.pfm")) is None
    np.testing.assert_array_equal(datasets.load_gt_depth_pfm(str(tmp_path / "b.pfm")),
                                  jds.load_gt_depth_pfm(str(tmp_path / "b.pfm")))


# ---- loaders ---------------------------------------------------------------

def _same_seq(a, b):
    assert a.left_paths == b.left_paths and a.right_paths == b.right_paths
    assert a.names == b.names and len(a) == len(b)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    if b.gt_poses is None:
        assert a.gt_poses is None
    else:
        assert a.gt_poses.dtype == b.gt_poses.dtype
        np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    assert getattr(a, "depth_paths", None) == getattr(b, "depth_paths", None)
    for i in range(len(b)):
        ma, mb = a.meta(i), b.meta(i)
        assert ma[0] == mb[0] and ma[2] == mb[2]


def _stereo_layout(root, n, rng, left="image_0", right="image_1", names=None):
    os.makedirs(os.path.join(root, left), exist_ok=True)
    os.makedirs(os.path.join(root, right), exist_ok=True)
    names = names or [f"{i:06d}.png" for i in range(n)]
    for nm in names:
        for d in (left, right):
            png.write_png(os.path.join(root, d, nm), _image(rng, "g8", 12, 16))
    return names


def _poses(rng, n):
    return np.stack([np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                                     rng.normal(size=(3, 1))], 1).reshape(-1)
                     for _ in range(n)])


def test_load_kitti(tmp_path):
    rng = np.random.default_rng(0)
    root = str(tmp_path)
    _stereo_layout(root, 6, rng)
    np.savetxt(os.path.join(root, "times.txt"), np.arange(6) * 0.1037)
    np.savetxt(os.path.join(root, "gt.txt"), _poses(rng, 6))
    for args in ((None, 0, -1), (os.path.join(root, "gt.txt"), 1, 4),
                 (os.path.join(root, "gt.txt"), 2, 99)):
        seq = datasets.load_kitti_stereo(root, *args)
        _same_seq(seq, jds.load_kitti_stereo(root, *args))
    left, right, t, gt, name = seq[1]
    jl, jr, jt, jgt, jname = jds.load_kitti_stereo(root, *args)[1]
    np.testing.assert_array_equal(left, jl)
    np.testing.assert_array_equal(right, jr)
    assert (t, name) == (jt, jname)
    np.testing.assert_array_equal(gt, jgt)


def test_load_euroc(tmp_path):
    root = str(tmp_path)
    stamps = ["1403636579763555584", "1403636579813555456", "1403636579863555584"]
    _stereo_layout(root, 3, np.random.default_rng(1), "mav0/cam0/data", "mav0/cam1/data",
                   [s + ".png" for s in stamps])
    (tmp_path / "ts.txt").write_text("\n".join(stamps) + "\n\n")
    _same_seq(datasets.load_euroc_stereo(root, str(tmp_path / "ts.txt")),
              jds.load_euroc_stereo(root, str(tmp_path / "ts.txt")))


@pytest.mark.parametrize("with_times", [False, True])
def test_load_jackal(tmp_path, with_times):
    root = str(tmp_path)
    _stereo_layout(root, 4, np.random.default_rng(2), names=["b.png", "a.png", "c.png"])
    if with_times:
        np.savetxt(os.path.join(root, "times.txt"), [3.5, 3.6, 3.7, 3.8])
    _same_seq(datasets.load_jackal_session(root), jds.load_jackal_session(root))


@pytest.mark.parametrize("gt_kind", ["none", "kitti", "airsim", "missing"])
def test_load_airsim(tmp_path, gt_kind):
    rng = np.random.default_rng(3)
    root = str(tmp_path)
    names = _stereo_layout(root, 5, rng)
    gt = os.path.join(root, "gt.txt")
    if gt_kind == "kitti":
        np.savetxt(gt, _poses(rng, 5))
    elif gt_kind == "airsim":
        q = rng.normal(size=(5, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        np.savetxt(gt, np.concatenate([np.arange(5)[:, None] * 0.1,
                                       rng.normal(size=(5, 3)), q], 1))
    os.makedirs(os.path.join(root, "img_depth"))
    for nm in names[:3]:
        pfm.write_pfm(os.path.join(root, "img_depth", nm[:-4] + ".pfm"),
                      rng.uniform(1, 9, (12, 16)).astype(np.float32))
    path = None if gt_kind == "none" else gt
    seq = datasets.load_airsim_stereo(root, path, load_gt_depth=True)
    jseq = jds.load_airsim_stereo(root, path, load_gt_depth=True)
    _same_seq(seq, jseq)
    for p, jp in zip(seq.depth_paths, jseq.depth_paths):
        a, b = datasets.load_gt_depth_pfm(p), jds.load_gt_depth_pfm(jp)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_load_tum(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    lines, assoc = ["# color images", "# timestamp filename"], []
    rng = np.random.default_rng(4)
    for i in range(4):
        t = f"{1305031102.175304 + i * 0.0333:.6f}"
        png.write_png(os.path.join(root, "rgb", f"{t}.png"), _image(rng, "rgb", 12, 16))
        png.write_png(os.path.join(root, "depth", f"{t}.png"), _image(rng, "g16", 12, 16))
        lines.append(f"{t} rgb/{t}.png")
        assoc.append(f"{t} rgb/{t}.png {t} depth/{t}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "assoc.txt").write_text("# comment\n" + "\n".join(assoc) + "\n")
    _same_seq(datasets.load_tum_mono(root), jds.load_tum_mono(root))
    got = datasets.load_tum_rgbd(root, str(tmp_path / "assoc.txt"))
    want = jds.load_tum_rgbd(root, str(tmp_path / "assoc.txt"))
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    # colour frames in grey, as cv2's IMREAD_GRAYSCALE gives them
    np.testing.assert_array_equal(datasets.load_gray(got[0][0]), jds.load_gray(got[0][0]))


# ---- rectification -----------------------------------------------------------

def _random_calib(rng):
    K = np.array([[450.0, 0, 370.0], [0, 455.0, 245.0], [0, 0, 1]]) + rng.normal(size=(3, 3)) \
        * np.array([[3, 0, 3], [0, 3, 3], [0, 0, 0]])
    D = np.array([-0.28, 0.07, 2e-4, 1.7e-5, -0.01]) * rng.uniform(0.5, 1.5, 5)
    R = cv2.Rodrigues(rng.normal(size=3) * 0.01)[0]
    P = np.concatenate([K * [[1.01], [1.0], [1.0]], [[0.0], [0.0], [0.0]]], 1)
    return K, D, R, P


def test_rectification_maps_match_numpy_formula(monkeypatch):
    """Exactly the JAX package's formula for a machine without cv2."""
    K, D, R, P = _random_calib(np.random.default_rng(5))
    got = rectify.rectification_maps(K, D, R, P, 97, 61)
    monkeypatch.setitem(sys.modules, "cv2", None)
    want = jrect.rectification_maps(K, D, R, P, 97, 61)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_rectification_maps_near_cv2():
    K, D, R, P = _random_calib(np.random.default_rng(6))
    got = rectify.rectification_maps(K, D, R, P, 752, 480)
    want = cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (752, 480), cv2.CV_32FC1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize("side", ["LEFT", "RIGHT"])
def test_load_rectification_from_yaml(monkeypatch, side):
    got = rectify.load_rectification_from_yaml(_parse_opencv_yaml(EUROC), side)
    monkeypatch.setitem(sys.modules, "cv2", None)
    want = jrect.load_rectification_from_yaml(j_parse_yaml(EUROC), side)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    doc = dict(_parse_opencv_yaml(EUROC))
    del doc[f"{side}.P"], doc[f"{side}.height"]
    with pytest.raises(ValueError, match=rf"{side}\.\{{P, height\}}"):
        rectify.load_rectification_from_yaml(doc, side)
    with pytest.raises(ValueError):
        jrect.load_rectification_from_yaml(doc, side)
    assert rectify.load_rectification_from_yaml(doc, side, strict=False) is None


def _maps(rng, h, w):
    return (rng.uniform(-3, w + 3, (h, w)).astype(np.float32),
            rng.uniform(-3, h + 3, (h, w)).astype(np.float32))


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("kind", ["g8", "g16", "rgb"])
def test_remap_matches_cv2(interp, kind):
    """Bit-equal to cv2.remap on random maps (taps outside the image, half
    pixels) and on EuRoC's rectification maps; numpy in, numpy out, and
    tensors in, tensors out."""
    rng = np.random.default_rng(7)
    flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_NEAREST
    img = _image(rng, kind, 480, 752)
    mx, my = _maps(rng, 480, 752)
    half = ((rng.integers(-4, 2 * 752 + 4, (480, 752)) / 2).astype(np.float32),
            (rng.integers(-4, 2 * 480 + 4, (480, 752)) / 2).astype(np.float32))
    euroc = rectify.load_rectification_from_yaml(_parse_opencv_yaml(EUROC), "LEFT")
    for m in ((mx, my), half, euroc):
        want = cv2.remap(img, m[0], m[1], flag)
        got = rectify.remap(img, m, interp)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    t = rectify.remap(torch.as_tensor(img), (torch.as_tensor(mx), torch.as_tensor(my)), interp)
    np.testing.assert_array_equal(t.numpy(), cv2.remap(img, mx, my, flag))


# ---- the loader ----------------------------------------------------------------

@pytest.mark.parametrize("right_mode", ["gray", "unchanged", "skip"])
def test_prefetcher_matches_direct_decoding(tmp_path, right_mode):
    """Frames in order, equal to decoding each file directly (and to the JAX
    package's thread-pool loader); rectified when maps are given."""
    rng = np.random.default_rng(8)
    n, lefts, rights = 7, [], []
    for i in range(n):
        lefts.append(str(tmp_path / f"l{i}.png"))
        rights.append(str(tmp_path / f"r{i}.png"))
        png.write_png(lefts[-1], _image(rng, "rgb", 40, 56), filter_type=i % 5)
        png.write_png(rights[-1], _image(rng, "g16" if right_mode == "unchanged" else "g8",
                                         40, 56), filter_type=4)
    maps = (_maps(rng, 40, 56), None) if right_mode != "unchanged" else None
    got, want = [], []
    with prefetch.StereoPrefetcher(lefts, rights, rect_maps=maps, prefetch=3, threads=3,
                                   right_mode=right_mode) as pf:
        assert len(pf) == n
        got = [pf.next() for _ in range(n)]
        with pytest.raises(StopIteration):
            pf.next()
    jpf = jpre.StereoPrefetcher(lefts, rights, rect_maps=maps, use_native=False,
                                right_mode=right_mode)
    want = [jpf.next() for _ in range(n)]
    jpf.close()
    for i, ((l, r), (jl, jr)) in enumerate(zip(got, want)):
        direct = datasets.load_gray(lefts[i])
        if maps is not None:
            direct = rectify.remap(direct, maps[0])
        np.testing.assert_array_equal(l, direct)
        np.testing.assert_array_equal(l, jl)
        if right_mode == "skip":
            assert r is None and jr is None
        else:
            assert r.dtype == jr.dtype
            np.testing.assert_array_equal(r, jr)
            np.testing.assert_array_equal(
                r, png.read_png(rights[i], "unchanged" if right_mode == "unchanged" else "gray"))
    assert prefetch.native_available() is False


def test_prefetcher_missing_file(tmp_path):
    """As the JAX package's thread-pool path: next() raises FileNotFoundError."""
    path = str(tmp_path / "a.png")
    png.write_png(path, np.zeros((8, 8), np.uint8))
    missing = str(tmp_path / "missing.png")
    with prefetch.StereoPrefetcher([path, path], [path, missing]) as pf:
        pf.next()
        with pytest.raises(FileNotFoundError):
            pf.next()
    jpf = jpre.StereoPrefetcher([path, path], [path, missing], use_native=False)
    jpf.next()
    with pytest.raises(FileNotFoundError):
        jpf.next()
    jpf.close()


# ---- small pieces --------------------------------------------------------------

def test_undistort_points():
    rng = np.random.default_rng(9)
    pts = rng.uniform([0, 0], [752, 480], (200, 2)).astype(np.float32)
    dist = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0], np.float32)
    args = (458.654, 457.296, 367.215, 248.375)
    want = np.asarray(jcam.undistort_points(pts, *args, dist))
    got = camera.undistort_points(torch.as_tensor(pts), *args, torch.as_tensor(dist))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # distortion 0: the identity
    ident = camera.undistort_points(torch.as_tensor(pts), *args, [0.0] * 5)
    np.testing.assert_allclose(ident.numpy(), pts, rtol=0, atol=1e-3)


def test_stage_timer_report():
    a, b = profiling.StageTimer(), jprof.StageTimer()
    for i, name in enumerate(["frontend", "track", "frontend", "keyframe_event", "track"]):
        with a.time(name):
            pass
        a.samples[name][-1] = 0.001 * (i + 1) ** 1.5
        b.samples[name].append(0.001 * (i + 1) ** 1.5)
    assert a.stats() == b.stats()
    assert a.report() == b.report()
