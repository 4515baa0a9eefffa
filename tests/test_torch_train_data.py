"""Port parity: the FCN's training data (iv_slam_tpu_torch.train.data)
against the JAX package's on a tiny dataset written here, and the port's
standard-library PNG reader against imageio.

The JAX dataset resizes with cv2.INTER_LINEAR, which interpolates uint8
images in fixed point (11-bit weights); the port computes the same
bilinear geometry in float64 and rounds half up. So a resized pixel may
differ by one grey level (measured: at most 1, on ~12% of the pixels of a
360x1240 -> 512x512 resize), a normalized input value by 1/255/0.225, a
target by 1/255, and a binarized target flips where the two resizes fall
on either side of 180: the test counts those flips and holds them to 2% of
the target pixels. Masks (binarized at 127) are held the same way. Batch
order, names, sessions and the post-processing dataset's keypoints are
exact.
"""

import json
import os
import struct
import zlib

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from iv_slam_tpu.train import data as jdata
from iv_slam_tpu_torch.introspection.dataset_creator import write_png
from iv_slam_tpu_torch.train import data as tdata

INPUT_HW = (32, 48)


def smooth(rng, h, w, sigma=2.0):
    img = cv2.GaussianBlur(rng.uniform(0, 255, (h, w)).astype(np.float32), (0, 0), sigma)
    return np.clip((img - img.mean()) * 4 + 128, 0, 255).astype(np.uint8)


def encode_png(img, filters):
    """A PNG of `img` (uint8 (H, W) or (H, W, C)) whose row y uses filter
    filters[y % len(filters)], encoded by the spec's definitions."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        cur, ft = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(ft)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def filter_types(path):
    """The row filter types used in a PNG file."""
    with open(path, "rb") as f:
        d = f.read()
    pos, idat = 8, b""
    while pos < len(d):
        (n,) = struct.unpack(">I", d[pos:pos + 4])
        if d[pos + 4:pos + 8] == b"IHDR":
            w, h, _, ct = struct.unpack(">IIBB", d[pos + 8:pos + 18])
        elif d[pos + 4:pos + 8] == b"IDAT":
            idat += d[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ct] + 1
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_matches_imageio(tmp_path, channels):
    """Files PIL writes (its own filter choice per row) and files encoded
    here with each filter type 0-4 on every row and mixed: the port's
    reader gives imageio's array, shape and dtype included."""
    rng = np.random.default_rng(channels)
    img = np.stack([smooth(rng, 37, 53) for _ in range(channels)], -1)
    img = img[..., 0] if channels == 1 else img
    seen = set()
    pil = str(tmp_path / "pil.png")
    Image.fromarray(img).save(pil)
    seen |= filter_types(pil)
    paths = [pil]
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        p = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        with open(p, "wb") as f:
            f.write(encode_png(img, filters))
        seen |= filter_types(p)
        paths.append(p)
    assert seen == {0, 1, 2, 3, 4}
    for p in paths:
        want, got = iio.imread(p), tdata.read_image(p)
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)
    # the dataset writer's files read back too
    w = str(tmp_path / "writer.png")
    write_png(w, img if channels == 1 else img[..., 0])
    np.testing.assert_array_equal(tdata.read_image(w), iio.imread(w))


@pytest.mark.parametrize("src,dst", [((360, 1240), (512, 512)), ((360, 1240), (64, 64)),
                                     ((100, 100), (50, 50)), ((37, 53), (64, 64))])
def test_resize_linear_within_one_level_of_cv2(src, dst):
    img = smooth(np.random.default_rng(sum(src)), *src)
    got = tdata.resize_linear(img, dst[1], dst[0]).astype(int)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR).astype(int)
    d = np.abs(got - want)
    print(f"{src} -> {dst}: {float((d > 0).mean()):.2%} of pixels one level apart")
    assert got.shape == want.shape and d.max() <= 1 and (d > 0).mean() < 0.2
    if src == (100, 100):          # an exact 2x shrink: cv2's area path, equal
        assert d.max() == 0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two sessions of generated_training_data (heatmaps, masks on the
    first only, keypoints.json and img_names.json) beside their raw
    images, grey in session 0 and RGB in session 1, and network outputs."""
    root = tmp_path_factory.mktemp("ds")
    data_root, raw_root, net_root = root / "gen", root / "raw", root / "net"
    rng = np.random.default_rng(7)
    for s in (0, 1):
        sdir = data_root / f"{s:05d}" / "generated_training_data"
        for sub in ("bad_region_heatmap", "bad_region_heatmap_mask"):
            (sdir / sub).mkdir(parents=True)
        (raw_root / f"{s:05d}" / "image_0").mkdir(parents=True)
        (net_root / f"{s:05d}").mkdir(parents=True)
        kp = dict(x_coord=[], y_coord=[], response=[], size=[], epipolar_err=[])
        names = dict(img_name=[], corresponding_keypt_id=[], corresponding_descriptor_id=[])
        for i in range(3):
            name = f"{i:06d}.png"
            raw = smooth(rng, 60, 90) if s == 0 else np.stack(
                [smooth(rng, 60, 90) for _ in range(3)], -1)
            Image.fromarray(raw).save(raw_root / f"{s:05d}" / "image_0" / name)
            Image.fromarray(smooth(rng, 50, 80, 4.0)).save(sdir / "bad_region_heatmap" / name)
            if s == 0:
                Image.fromarray(np.where(smooth(rng, 50, 80, 6.0) > 128, 255, 0)
                                .astype(np.uint8)).save(sdir / "bad_region_heatmap_mask" / name)
            Image.fromarray(smooth(rng, 50, 80)).save(net_root / f"{s:05d}" / name)
            n = int(rng.integers(3, 8))
            ids = list(range(len(kp["x_coord"]), len(kp["x_coord"]) + n))
            for key, hi in (("x_coord", 80), ("y_coord", 50), ("response", 1),
                            ("size", 31), ("epipolar_err", 3)):
                kp[key] += rng.uniform(0, hi, n).tolist()
            names["img_name"].append(name)
            names["corresponding_keypt_id"].append({"keypt_id": ids})
        (sdir / "keypoints.json").write_text(json.dumps(kp))
        (sdir / "img_names.json").write_text(json.dumps(names))
    return str(data_root), str(raw_root), str(net_root)


@pytest.mark.parametrize("binarize", [False, True])
def test_samples_match_jax(dataset, binarize):
    data_root, raw_root, _ = dataset
    j = jdata.ImageQualityDataset(data_root, raw_root, [0, 1], INPUT_HW, binarize=binarize)
    t = tdata.ImageQualityDataset(data_root, raw_root, [0, 1], INPUT_HW, binarize=binarize)
    assert len(t) == len(j) == 6 and t.entries == j.entries
    flips = n_tgt = 0
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert (b.session, b.name) == (a.session, a.name)
        for f in ("image", "target", "mask"):
            assert getattr(b, f).shape == getattr(a, f).shape
            assert getattr(b, f).dtype == getattr(a, f).dtype == np.float32
        np.testing.assert_allclose(b.image, a.image, atol=1.0 / 255 / 0.224 + 1e-6)
        if binarize:
            flips += int((b.target != a.target).sum())
        else:
            np.testing.assert_allclose(b.target, a.target, atol=1.0 / 255 + 1e-7)
        n_tgt += a.target.size
        assert float((b.mask != a.mask).mean()) <= 0.02
    print(f"binarize={binarize}: {flips} of {n_tgt} target pixels flipped")
    assert flips <= 0.02 * n_tgt


def test_batch_order_matches_jax(dataset):
    """Shuffled with the same seed, the batches hold the same samples in
    the same order; a last partial batch is dropped in both."""
    data_root, raw_root, _ = dataset
    j = jdata.ImageQualityDataset(data_root, raw_root, [0, 1], INPUT_HW)
    t = tdata.ImageQualityDataset(data_root, raw_root, [0, 1], INPUT_HW)
    jb = list(j.batches(4, np.random.default_rng(3)))
    tb = list(t.batches(4, np.random.default_rng(3)))
    assert len(jb) == len(tb) == 1
    for a, b in zip(jb, tb):
        for k in ("image", "target", "mask"):
            assert a[k].shape == b[k].shape
        order = [int(np.argmin([np.abs(x - y).sum() for y in [t[i].image for i in range(6)]]))
                 for x in b["image"]]
        want = [int(np.argmin([np.abs(x - y).sum() for y in [j[i].image for i in range(6)]]))
                for x in a["image"]]
        assert order == want
    assert len(list(t.batches(6, np.random.default_rng(0), shuffle=False))) == 1


def test_pp_dataset_and_retention_curve_match_jax(dataset):
    data_root, raw_root, net_root = dataset
    j = jdata.ImageQualityDatasetPP(data_root, raw_root, [0, 1], net_root)
    t = tdata.ImageQualityDatasetPP(data_root, raw_root, [0, 1], net_root)
    assert len(t) == len(j) == 6
    for i in range(6):
        a, b = j[i], t[i]
        for f in ("image", "score_img", "network_output", "keypt_xy", "keypt_response",
                  "keypt_epipolar_err"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        assert (b.session, b.name) == (a.session, a.name)
        cost = b.network_output[np.clip(b.keypt_xy[:, 1].astype(int), 0, 49),
                                np.clip(b.keypt_xy[:, 0].astype(int), 0, 79), 0]
        assert tdata.retention_curve(cost, b.keypt_epipolar_err) == jdata.retention_curve(
            cost, b.keypt_epipolar_err)
    # the reference stores network outputs as .jpg: without a PNG of the name
    # both packages read the .jpg beside it, to the same pixels
    import cv2

    png_path = os.path.join(net_root, "00000", "000000.png")
    cv2.imwrite(png_path[:-4] + ".jpg", cv2.imread(png_path, cv2.IMREAD_UNCHANGED))
    os.remove(png_path)
    a, b = j[0], t[0]
    np.testing.assert_array_equal(b.network_output, a.network_output)
