"""PNG reader and writer of the port, with the standard library's zlib.

The counterpart of ``iv_slam_tpu/io/datasets.py::load_gray`` (which reads
with OpenCV, or imageio without it) and of the decode half of the
reference's native loader. The port reads every image through here:
datasets, the training dataset and the drivers.

``read_png(path, mode)``:

* ``mode="gray"`` returns what ``cv2.imread(path, IMREAD_GRAYSCALE)``
  returns: an (H, W) uint8 image. OpenCV decodes with libpng and asks it
  to convert: 16-bit samples keep their high byte, alpha is dropped, a
  palette expands to RGB, 1-, 2- and 4-bit grey scale to 8 bits (x255,
  x85, x17), and RGB becomes grey by libpng's fixed-point formula with
  OpenCV's coefficients 0.299 and 0.587 as 15-bit integers (9797, 19234
  and the 3737 left over), a pixel with three equal samples passing
  through. Without a file gamma the sum is truncated for 8-bit samples and
  rounded for 16-bit ones. With one (``gAMA``, or ``sRGB``, which means
  45455 and wins over ``gAMA``; either counts only before PLTE and IDAT,
  and the first ``gAMA`` from 1 to 2**31 - 1 wins) that is at least 0.05
  from 1.0, libpng converts in linear light through its integer tables:
  8-bit samples (a palette's entries too) through 8-bit "to linear" and
  "from linear" tables, 16-bit ones through 16-bit tables indexed by their
  top 11 bits (fewer if ``sBIT`` says so), a grey 16-bit pixel through the
  16-to-8 table; ``_gamma_tables`` copies libpng 1.6's construction. ``cHRM``,
  ``iCCP`` (probed with a littleCMS sRGB profile) and ``cICP`` leave the
  grey unchanged: OpenCV sets the coefficients itself, and libpng applies
  no profile. Grey and grey+alpha files ignore the gamma.
* ``mode="unchanged"`` returns what ``imageio.v3.imread`` returns: grey as
  (H, W) uint8 or uint16 (1-bit grey as bool, 2- and 4-bit scaled to 8
  bits), grey+alpha, RGB and RGBA as (H, W, C) uint8 (a 16-bit colour
  sample keeps its high byte; 16-bit grey+alpha becomes RGBA, the grey
  thrice, as pillow opens it), a palette expanded to RGB. Every chunk but
  IHDR, PLTE and IDAT is ignored, gamma included.
  A tRNS chunk is ignored in both modes, as imageio's pillow plugin does
  (it converts a palette image to its palette's mode, RGB) and as cv2's
  IMREAD_GRAYSCALE does (alpha is dropped).

Every bit depth the format allows is read: 8 and 16 for every colour type,
1, 2 and 4 for grey and palette indices; Adam7-interlaced files too, each of
the seven passes unfiltered on its own. The row filters are undone by
``unfilter``, a C loop (``csrc/png_unfilter.c``) built at first use with the
host compiler and called through ctypes, which releases the interpreter
lock while it runs; its build failure raises. ``unfilter_plain`` is the
NumPy version the tests hold it against.

``write_png`` writes grey (uint8 or uint16), grey+alpha, RGB and RGBA
images with one row filter for every row (0 none ... 4 Paeth).
"""

from __future__ import annotations

import ctypes
import functools
import math
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


# libpng's gamma arithmetic (png.c, pngrtran.c), in its fixed point: 1.0 is
# 100000; a gamma within 0.05 of 1.0 is not "significant"; sRGB's gamma
PNG_FP_1, GAMMA_THRESHOLD, GAMMA_SRGB = 100000, 5000, 45455
MAX_GAMMA_8 = 11          # bits of a 16-bit sample the tables keep when it ends as 8
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))   # the seven passes: x0, y0, dx, dy


def _significant(g: int) -> bool:
    return abs(g - PNG_FP_1) > GAMMA_THRESHOLD


def _reciprocal(a: int) -> int:
    """png_reciprocal: 1/a in fixed point, 0 when it leaves 32 bits."""
    r = math.floor(1e10 / a + .5)
    return r if r < 2 ** 31 else 0


def _table8(g: int) -> np.ndarray:
    """png_build_8bit_table: 256 entries, 255 * (v / 255) ** g rounded."""
    if not _significant(g):
        return np.arange(256, dtype=np.int64)
    return np.array([v if v in (0, 255) else math.floor(255 * math.pow(v / 255., g * .00001) + .5)
                     for v in range(256)], np.int64)


def _gamma16(v: int, g: int) -> int:
    """png_gamma_16bit_correct."""
    if 0 < v < 65535:
        return math.floor(65535 * math.pow(v / 65535., g * .00001) + .5)
    return v


def _table16(g: int, shift: int) -> np.ndarray:
    """png_build_16bit_table: [(v & 0xff) >> shift, v >> 8] -> 16 bits."""
    mx = (1 << (16 - shift)) - 1
    ig = (np.arange(256)[None, :] << (8 - shift)) + np.arange(1 << (8 - shift))[:, None]
    if not _significant(g):
        return (ig * 65535 + (1 << (15 - shift))) // mx
    return np.vectorize(lambda i: math.floor(65535. * math.pow(i * (1.0 / mx), g * .00001) + .5),
                        otypes=[np.int64])(ig)


def _table16to8(g: int, shift: int) -> np.ndarray:
    """png_build_16to8_table: [(v & 0xff) >> shift, v >> 8] -> an 8-bit
    value times 257, from the boundaries between output levels."""
    num, mx = 1 << (8 - shift), (1 << (16 - shift)) - 1
    flat = np.full(num << 8, 65535, np.int64)        # by the top 16 - shift bits
    last = 0
    for i in range(255):
        bound = (_gamma16(i * 257 + 128, g) * mx + 32768) // 65535 + 1
        flat[last:max(last, bound)] = i * 257
        last = max(last, bound)
    return flat.reshape(256, num).T


@functools.lru_cache(maxsize=16)
def _gamma_tables(gamma: int, depth: int, shift: int):
    """libpng's rgb_to_gray tables for file gamma `gamma` and `depth`-bit
    samples: (to linear, from linear, pass-through), or None when neither
    the file gamma nor its reciprocal (libpng's default screen gamma) is
    significant. At 16 bits each is indexed [(v & 0xff) >> shift, v >> 8]."""
    screen = _reciprocal(gamma)
    if not (_significant(gamma) or _significant(screen)):
        return None
    to1, from1 = _reciprocal(gamma), _reciprocal(screen) if screen else gamma
    if depth == 8:
        same = math.floor(1e15 / gamma / screen + .5) if screen else PNG_FP_1
        return _table8(to1), _table8(from1), _table8(same)
    same = math.floor(gamma * 1e-5 * screen + .5) if screen else PNG_FP_1
    return _table16(to1, shift), _table16(from1, shift), _table16to8(same, shift)


def _to_gray(rgb: np.ndarray, depth: int, gamma: int = 0, sig_bits: int = 0) -> np.ndarray:
    """libpng's rgb_to_gray with OpenCV's coefficients, (..., 3) samples ->
    (...) at the same depth; in linear light when the file gamma `gamma`
    (0: none) is significant, 16-bit tables keeping `sig_bits` (0: all)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    same = (r == g) & (r == b)
    shift = min(max(16 - sig_bits if 0 < sig_bits < 16 else 0, 16 - MAX_GAMMA_8), 8)
    tables = _gamma_tables(gamma, depth, shift) if gamma else None
    if tables is None:
        s = GRAY_R * r + GRAY_G * g + GRAY_B * b
        return np.where(same, r, (s + 16384 if depth == 16 else s) >> 15).astype(rgb.dtype)
    to1, from1, through = tables

    def look(t, v):
        return t[v] if depth == 8 else t[(v & 0xff) >> shift, v >> 8]

    s = (GRAY_R * look(to1, r) + GRAY_G * look(to1, g) + GRAY_B * look(to1, b) + 16384) >> 15
    return np.where(same, look(through, r), look(from1, s)).astype(rgb.dtype)


def _samples(px: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, ch) samples (uint8; uint16 at
    16 bits; 1-, 2- and 4-bit samples most significant first)."""
    h = px.shape[0]
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return px.reshape(h, w, ch)
    bits = np.unpackbits(px, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, ch)


def _pixels(raw: bytes, w: int, h: int, ch: int, depth: int, interlace: int,
            name: str) -> np.ndarray:
    """The (h, w, ch) samples of the decompressed image data `raw`, row
    filters undone (each Adam7 pass on its own)."""
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    shapes = [((h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx) for x0, y0, dx, dy in passes]
    need = sum(ph * ((pw * ch * depth + 7) // 8 + 1) for ph, pw in shapes if ph and pw)
    if len(raw) < need:
        raise ValueError(f"{name}: image data ends early")
    buf = np.frombuffer(raw, np.uint8, count=need)
    img = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw) in zip(passes, shapes):
        if ph == 0 or pw == 0:      # an empty pass has no rows, not even filter bytes
            continue
        stride = (pw * ch * depth + 7) // 8
        rows = buf[pos:pos + ph * (stride + 1)].reshape(ph, stride + 1)
        pos += ph * (stride + 1)
        img[y0::dy, x0::dx] = _samples(unfilter(rows, bpp), pw, ch, depth)
    return img


def decode_png(data: bytes, mode: str = "unchanged", name: str = "<bytes>") -> np.ndarray:
    """The image in PNG file contents `data`; see the module docstring for
    `mode` ("gray" or "unchanged")."""
    if mode not in ("gray", "unchanged"):
        raise ValueError(f"mode {mode!r}")
    hdr, plte, idat = None, None, []
    gamma = srgb = sig_bits = 0
    for tag, body in _chunks(data, name):
        early = plte is None and not idat      # libpng reads these before PLTE and IDAT only
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"gAMA" and early and not gamma and len(body) == 4 \
                and 0 < struct.unpack(">I", body)[0] < 2 ** 31:
            (gamma,) = struct.unpack(">I", body)
        elif tag == b"sRGB" and early and len(body) == 1:
            srgb = GAMMA_SRGB
        elif tag == b"sBIT" and early and hdr is not None and len(body) >= 3 \
                and hdr[3] in (2, 6):
            sig_bits = max(body[:3])
    if hdr is None:
        raise ValueError(f"{name} has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    ok_depth = depth in (1, 2, 4, 8, 16) if ctype == 0 else \
        depth in (1, 2, 4, 8) if ctype == 3 else depth in (8, 16)
    if ctype not in CHANNELS or not ok_depth or interlace not in (0, 1):
        raise NotImplementedError(
            f"{name}: bit depth {depth}, colour type {ctype}, interlace {interlace}: not "
            "a PNG image the format defines")
    ch = CHANNELS[ctype]
    img = _pixels(zlib.decompress(b"".join(idat)), w, h, ch, depth, interlace, name)
    gamma = srgb or gamma
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette image without PLTE")
        idx = np.minimum(img[..., 0].astype(np.int64), len(plte) - 1)
        return _to_gray(plte, 8, gamma)[idx] if mode == "gray" else plte[idx]
    if ctype == 0 and depth < 8:
        if mode == "unchanged" and depth == 1:
            return img[..., 0] != 0
        return img[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    if mode == "gray":
        img = _to_gray(img, depth, gamma, sig_bits) if ch >= 3 else img[..., 0]
        return (img >> 8).astype(np.uint8) if depth == 16 else img
    if ch == 1:
        return img[..., 0]
    if ctype == 4 and depth == 16:      # pillow opens it as RGBA
        img = img[..., [0, 0, 0, 1]]
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


def write_png(path: str, img: np.ndarray, filter_type: int = 0, level: int = 6) -> None:
    """Write (H, W) uint8/uint16 grey, or (H, W, C) uint8 with C 2 (grey +
    alpha), 3 (RGB) or 4 (RGBA), as a PNG whose rows all carry filter
    `filter_type` (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth), deflated at
    zlib `level` (1 with run-length matching: cv2.imwrite's default speed
    setting; zlib's default 6 otherwise)."""
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
        if level == 1:
            z = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
            data = z.compress(rows.tobytes()) + z.flush()
        else:
            data = zlib.compress(rows.tobytes(), level)
        f.write(chunk(b"IDAT", data))
        f.write(chunk(b"IEND", b""))
