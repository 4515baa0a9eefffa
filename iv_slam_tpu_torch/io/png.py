"""PNG reader and writer of the port, with the standard library's zlib.

The counterpart of ``iv_slam_tpu/io/datasets.py::load_gray`` (which reads
with OpenCV, or imageio without it) and of the decode half of the
reference's native loader. The port reads every image through here:
datasets, the training dataset and the drivers.

``read_png(path, mode)``:

* ``mode="gray"`` returns what ``cv2.imread(path, IMREAD_GRAYSCALE)``
  returns: an (H, W) uint8 image. OpenCV decodes with libpng and asks it
  to convert: 16-bit samples keep their high byte, alpha is dropped, a
  palette expands to RGB, and RGB becomes grey by libpng's fixed-point
  formula with OpenCV's coefficients 0.299 and 0.587 as 15-bit integers
  (9797, 19234 and the 3737 left over), truncated for 8-bit samples and
  rounded for 16-bit ones, a pixel with three equal samples passing
  through. A file that carries a gamma chunk would make libpng convert in
  linear light; the port ignores the chunk.
* ``mode="unchanged"`` returns what ``imageio.v3.imread`` returns: grey as
  (H, W) uint8 or uint16, grey+alpha, RGB and RGBA as (H, W, C) uint8 (a
  16-bit colour sample keeps its high byte), a palette expanded to RGB.
  A tRNS chunk is ignored in both modes, as imageio's pillow plugin does
  (it converts a palette image to its palette's mode, RGB) and as cv2's
  IMREAD_GRAYSCALE does (alpha is dropped).

Bit depths 8 and 16 are read for every colour type, and 1, 2 and 4 for
palette indices; interlaced (Adam7) files raise. The row filters are
undone by ``unfilter``, a C loop (``csrc/png_unfilter.c``) built at first
use with the host compiler and called through ctypes, which releases the
interpreter lock while it runs; its build failure raises.
``unfilter_plain`` is the NumPy version the tests hold it against.

``write_png`` writes grey (uint8 or uint16), grey+alpha, RGB and RGBA
images with one row filter for every row (0 none ... 4 Paeth).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from .. import _kernels

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples a pixel
# OpenCV's png_set_rgb_to_gray(0.299, 0.587) in libpng's 15-bit fixed point
GRAY_R, GRAY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
GRAY_B = 32768 - GRAY_R - GRAY_G

_unfilter_fn = None


def _unfilter_row(ft: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline without its filter, in NumPy and Python."""
    if ft == 0:
        return line.copy()
    if ft == 1:                                 # Sub: a running sum per sample
        out = np.empty_like(line)
        for c in range(bpp):
            out[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint8)
        return out
    if ft == 2:                                 # Up
        return line + prev
    if ft not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ft}")
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if ft == 3:                             # Average
            pred = (a + b) >> 1
        else:                                   # Paeth
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        cur[x] = (cur[x] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) bytes; the plain
    version of ``unfilter``."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) uint8 filtered scanlines (filter byte first) ->
    (h, stride) uint8; bpp: bytes a complete pixel. Raises ValueError on an
    unknown filter type."""
    global _unfilter_fn
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape[0], rows.shape[1] - 1
    if stride < 0 or bpp < 1:
        raise ValueError(f"unfilter: rows {rows.shape}, bpp {bpp}")
    if _unfilter_fn is None:
        fn = _kernels.load("png_unfilter").png_unfilter
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        _unfilter_fn = fn
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter_fn(rows.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"unknown PNG filter type {rows[bad - 1, 0]} in row {bad - 1}")
    return out


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        yield tag, body
        if tag == b"IEND":
            return


def _to_gray(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's rgb_to_gray with OpenCV's coefficients, (H, W, 3) samples ->
    (H, W) at the same depth."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    s = GRAY_R * r + GRAY_G * g + GRAY_B * b
    gray = (s + 16384 if depth == 16 else s) >> 15
    same = (r == g) & (r == b)
    return np.where(same, r, gray).astype(rgb.dtype)


def decode_png(data: bytes, mode: str = "unchanged", name: str = "<bytes>") -> np.ndarray:
    """The image in PNG file contents `data`; see the module docstring for
    `mode` ("gray" or "unchanged")."""
    if mode not in ("gray", "unchanged"):
        raise ValueError(f"mode {mode!r}")
    hdr, plte, idat = None, None, []
    for tag, body in _chunks(data, name):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{name} has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if interlace != 0:
        raise NotImplementedError(f"{name}: interlaced (Adam7) PNGs are not read")
    ok_depth = depth in (1, 2, 4, 8) if ctype == 3 else depth in (8, 16)
    if ctype not in CHANNELS or not ok_depth:
        raise NotImplementedError(
            f"{name}: bit depth {depth}, colour type {ctype}; read are 8- and 16-bit "
            "grey, grey+alpha, RGB and RGBA, and 1- to 8-bit palette images")
    ch = CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{name}: image data ends early")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    px = unfilter(rows, bpp)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette image without PLTE")
        idx = np.unpackbits(px, axis=1, bitorder="big") if depth < 8 else px
        if depth < 8:   # depth-bit indices, most significant first
            bits = idx[:, :w * depth].reshape(h, w, depth).astype(np.uint16)
            idx = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(-1)
        rgb = plte[np.minimum(idx.astype(np.int64), len(plte) - 1)]
        return _to_gray(rgb, 8) if mode == "gray" else rgb
    img = px.view(">u2").astype(np.uint16) if depth == 16 else px
    img = img.reshape(h, w, ch)
    if mode == "gray":
        img = _to_gray(img, depth) if ch >= 3 else img[..., 0]
        return (img >> 8).astype(np.uint8) if depth == 16 else img
    if ch == 1:
        return img[..., 0]
    return (img >> 8).astype(np.uint8) if depth == 16 else img


def read_png(path: str, mode: str = "unchanged") -> np.ndarray:
    """The PNG at `path` (see the module docstring for `mode`); a missing
    file raises FileNotFoundError."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, mode, path)


def _filter(px: np.ndarray, ft: int, bpp: int) -> np.ndarray:
    """(h, stride) bytes -> the same rows under filter `ft` (the inverse of
    ``unfilter``), computed from the unfiltered bytes, so it vectorises."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if ft == 0:
        pred = np.zeros_like(x)
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = b
    elif ft == 3:
        pred = (a + b) >> 1
    elif ft == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"filter type {ft}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write (H, W) uint8/uint16 grey, or (H, W, C) uint8 with C 2 (grey +
    alpha), 3 (RGB) or 4 (RGBA), as a PNG whose rows all carry filter
    `filter_type` (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ch, depth = 1, 8 * img.dtype.itemsize
    elif img.ndim == 3 and img.dtype == np.uint8 and img.shape[2] in (2, 3, 4):
        ch, depth = img.shape[2], 8
    else:
        raise ValueError(f"write_png: unsupported image {img.shape} {img.dtype}")
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    h, w = img.shape[:2]
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    px = px.view(np.uint8).reshape(h, w * ch * depth // 8)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                           _filter(px, filter_type, max(1, ch * depth // 8))], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
