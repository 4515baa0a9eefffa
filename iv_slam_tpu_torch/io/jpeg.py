"""Baseline JPEG decoder and encoder of the port, as libjpeg(-turbo) codes.

The counterpart of the JPEG half of ``cv2.imread``/``cv2.imencode`` and of
imageio's (PIL's) JPEG reader, which the JAX package reads and writes
through (``iv_slam_tpu/io/datasets.py::load_gray``, ``train/data.py``,
``slam/live_viewer.py``, ``introspection/vis.py``). The port imports no
cv2, PIL or imageio.

``read_jpeg(path, mode)`` / ``decode(data, mode)`` read baseline
sequential files (SOF0/SOF1, 8-bit, Huffman), 1 or 3 components with any
sampling factors, restart intervals, several scans, and skip every APPn
(JFIF, Exif, Adobe) and COM segment. Progressive (SOF2) and arithmetic
(SOF9-SOF15) files raise ValueError naming the mode. Modes:

* ``"gray"``: (H, W) uint8, the first (Y) component, as
  ``cv2.imread(path, IMREAD_GRAYSCALE)`` and PIL's ``draft("L")`` give it
  (libjpeg's JCS_GRAYSCALE output: no colour conversion);
* ``"bgr"``: (H, W, 3) uint8 as ``cv2.imread(path, IMREAD_COLOR)``;
* ``"unchanged"``: as ``imageio.v3.imread`` (PIL): (H, W) grey or
  (H, W, 3) RGB.

The arithmetic is libjpeg's: dequantisation, the integer "islow" inverse
DCT (jidctint.c, 13-bit constants, its range-limit table), "fancy"
(triangular) upsampling of subsampled chroma (jdsample.c: h2v1, h1v2,
h2v2; replication for other ratios) with the edge rows repeated, and the
integer YCbCr->RGB tables (jdcolor.c). ``tests/test_torch_jpeg.py`` holds
it bit for bit against cv2 and PIL.

``encode(img, quality)`` / ``write_jpeg`` is ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, quality])``'s counterpart: a JFIF baseline file,
grey for an (H, W) image and YCbCr 4:2:0 for (H, W, 3) BGR (libjpeg's
integer RGB->YCbCr tables, its 2x2 box downsampling with alternating
bias), the standard tables scaled by IJG quality (jcparam.c: 5000/q below
50, 200 - 2q above), the integer "islow" forward DCT (jfdctint.c) and
rounding division, the standard Huffman tables, libjpeg's dummy blocks and
marker order.

The Huffman decoding and encoding of a scan run in a host C source,
``csrc/jpeg_huffman.c``, built at first use with the host compiler into
the ignored build directory and called through ctypes (its build failure
raises); ``huffman_decode_plain`` / ``huffman_encode_plain`` are its plain
Python versions, which the tests hold it against.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import _kernels

SOI, EOI = b"\xff\xd8", b"\xff\xd9"

# the zigzag scan: natural (row-major) index of the k-th coefficient
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# ITU T.81 annex K: quantisation tables (natural order) and Huffman tables
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# frame markers that are not baseline sequential Huffman
SOF_KINDS = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
             0xC6: "differential progressive", 0xC7: "differential lossless"}


# -------------------------------------------------------------- the integer DCTs

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _idct_lin(c):
    """jidctint.c's butterfly over the first axis (8 inputs, integers), before
    its descale: the 8 outputs stacked on the first axis."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (c[0] + c[4]) * (1 << CONST_BITS)
    tmp1 = (c[0] - c[4]) * (1 << CONST_BITS)
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * FIX_1_175875602
    o0, o1 = o0 * FIX_0_298631336, o1 * FIX_2_053119869
    o2, o3 = o2 * FIX_3_072711026, o3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3])


def _fdct_lin(d, first):
    """jfdctint.c's butterfly over the first axis before its descales (the
    first pass scales outputs 0 and 4 up by 2**PASS1_BITS instead)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    k = (1 << PASS1_BITS) if first else 1
    z1 = (t12 + t13) * FIX_0_541196100
    o2, o6 = z1 + t13 * FIX_0_765366865, z1 - t12 * FIX_1_847759065
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4, tmp5 = tmp4 * FIX_0_298631336, tmp5 * FIX_2_053119869
    tmp6, tmp7 = tmp6 * FIX_3_072711026, tmp7 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    return np.stack([(t10 + t11) * k, tmp7 + z1 + z4, o2, tmp6 + z2 + z3,
                     (t10 - t11) * k, tmp5 + z2 + z4, o6, tmp4 + z1 + z3])


# Each pass is an exact integer linear map followed by a rounding right
# shift: as 8x8 integer matrices, applied with float64 matrix products (every
# product and partial sum stays below 2**40, so float64 is exact).
_EYE = np.eye(8, dtype=np.int64)
IDCT_M = _idct_lin(_EYE).astype(np.float64)               # out = IDCT_M @ in
FDCT_M1 = _fdct_lin(_EYE, True).astype(np.float64)
FDCT_M2 = _fdct_lin(_EYE, False).astype(np.float64)
FDCT_S1 = np.array([0, 11, 11, 11, 0, 11, 11, 11], np.int64)   # descale of pass 1
FDCT_S2 = np.array([2, 15, 15, 15, 2, 15, 15, 15], np.int64)   # and of pass 2


def _apply(m, x, shift):
    """(n, 8) float64 integers -> (n, 8): DESCALE(m @ x, shift) per output,
    in float64 (exact: the values are integers below 2**53, and scaling by
    a power of two then flooring is the arithmetic right shift)."""
    shift = np.broadcast_to(np.asarray(shift, np.int64), (8,))
    bias = np.where(shift > 0, np.exp2(np.maximum(shift - 1, 0)), 0.0)
    return np.floor((x @ m.T + bias) * np.exp2(-shift.astype(np.float64)))


def _two_pass(m1, s1, m2, s2, x, cols_first):
    """Two 1-D passes over (N, 8, 8) blocks: columns then rows (or rows then
    columns), each as one matrix product over all blocks."""
    n = x.shape[0]
    a = x.transpose(0, 2, 1) if cols_first else x
    y = _apply(m1, a.reshape(-1, 8), s1).reshape(n, 8, 8)
    z = _apply(m2, y.transpose(0, 2, 1).reshape(-1, 8), s2).reshape(n, 8, 8)
    return z if cols_first else z.transpose(0, 2, 1)


def _range_limit():
    """jdmaster.c's table after jidctint's +CENTERJSAMPLE, indexed by the
    descaled sample & 1023: clamps to 0..255 within [-512, 511]."""
    v = np.arange(1024)
    return np.clip(np.where(v < 512, v, v - 1024) + 128, 0, 255).astype(np.uint8)


RANGE_LIMIT = _range_limit()


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) int16 coefficients (natural order) and their (64,) table ->
    (..., 8, 8) uint8 samples: jidctint.c's jpeg_idct_islow (columns, then
    rows; its all-zero shortcuts give the same numbers)."""
    lead = coef.shape[:-1]
    c = (coef.reshape(-1, 64).astype(np.float64) * qt.astype(np.float64)).reshape(-1, 8, 8)
    out = _two_pass(IDCT_M, CONST_BITS - PASS1_BITS, IDCT_M, CONST_BITS + PASS1_BITS + 3, c,
                    True)
    return RANGE_LIMIT[out.astype(np.int64) & 1023].reshape(lead + (8, 8))


def fdct_quantize(blocks: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 8, 8) uint8 samples and a (64,) table -> (..., 64) int16
    quantised coefficients (natural order): jfdctint.c's jpeg_fdct_islow
    (rows, then columns), then jcdctmgr.c's rounding division by 8 x the
    table entry."""
    lead = blocks.shape[:-2]
    d = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    d = _two_pass(FDCT_M1, FDCT_S1, FDCT_M2, FDCT_S2, d, False).reshape(-1, 64)
    # (|d| + q // 2) // q with the sign restored; float64 division of these
    # small integers floors exactly
    q = qt.astype(np.float64) * 8
    mag = np.floor((np.abs(d) + np.floor(q / 2)) / q)
    return np.copysign(mag, d).astype(np.int16).reshape(lead + (64,))


# --------------------------------------------------------------- colour tables

SCALEBITS, ONE_HALF = 16, 1 << 15


def _fix(x):
    return int(x * (1 << SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
CR_R = ((_fix(1.40200) * _X + ONE_HALF) >> SCALEBITS).astype(np.int32)
CB_B = ((_fix(1.77200) * _X + ONE_HALF) >> SCALEBITS).astype(np.int32)
CR_G = (-_fix(0.71414) * _X).astype(np.int32)
CB_G = (-_fix(0.34414) * _X + ONE_HALF).astype(np.int32)


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: (R, G, B) uint8 planes."""
    y = y.astype(np.int32)
    r = np.clip(y + CR_R[cr], 0, 255)
    g = np.clip(y + ((CB_G[cb] + CR_G[cr]) >> SCALEBITS), 0, 255)
    b = np.clip(y + CB_B[cb], 0, 255)
    return r.astype(np.uint8), g.astype(np.uint8), b.astype(np.uint8)


def rgb_to_ycc(r, g, b):
    """jccolor.c's rgb_ycc_convert: (Y, Cb, Cr) uint8 planes."""
    r, g, b = (np.asarray(a, np.int32) for a in (r, g, b))
    off = 128 << SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b + off + ONE_HALF - 1) \
        >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b + off + ONE_HALF - 1) \
        >> SCALEBITS
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


# ------------------------------------------------------------------ upsampling

def _rows_with_context(p):
    """The component's rows with the row above (first row repeated) and
    below (last row repeated): (above, rows, below) int64."""
    p = p.astype(np.int64)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    return above, p, below


def _h2_fancy(p, round_lo, round_hi, shift):
    """Horizontal 3:1 triangle over columns of an int64 plane of column sums
    (jdsample.c's h2 cases; edges take their own sample)."""
    w = p.shape[1]
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    even = (p * 3 + left + round_lo) >> shift
    odd = (p * 3 + right + round_hi) >> shift
    out = np.empty((p.shape[0], 2 * w), np.int64)
    out[:, 0::2], out[:, 1::2] = even, odd
    return out


def upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's (rows, cols) samples (its real extent) to fh x fv times
    the size, as libjpeg's fancy upsampler does."""
    if fh == 1 and fv == 1:
        return p
    w = p.shape[1]
    if fh == 2 and fv == 1 and w > 2:
        q = p.astype(np.int64)
        out = _h2_fancy(q, 1, 2, 2)
        out[:, 0], out[:, -1] = q[:, 0], q[:, -1]
        return out.astype(np.uint8)
    if fh == 2 and fv == 2 and w > 2:
        above, rows, below = _rows_with_context(p)
        outs = []
        for near in (above, below):
            cs = rows * 3 + near                           # column sums
            o = _h2_fancy(cs, 8, 7, 4)
            o[:, 0] = (cs[:, 0] * 4 + 8) >> 4
            o[:, -1] = (cs[:, -1] * 4 + 7) >> 4
            outs.append(o)
        out = np.empty((2 * p.shape[0], 2 * w), np.int64)
        out[0::2], out[1::2] = outs
        return out.astype(np.uint8)
    if fh == 1 and fv == 2:
        above, rows, below = _rows_with_context(p)
        out = np.empty((2 * p.shape[0], w), np.int64)
        out[0::2] = (rows * 3 + above + 1) >> 2
        out[1::2] = (rows * 3 + below + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)


# -------------------------------------------------------------- Huffman tables

def _decode_table(bits, vals):
    """T.81 F.2.2.3's maxcode/valptr/mincode and huffval as one int32 array
    (the layout csrc/jpeg_huffman.c reads)."""
    maxcode = np.full(17, -1, np.int32)
    valptr = np.zeros(17, np.int32)
    mincode = np.zeros(17, np.int32)
    code, k = 0, 0
    for l in range(1, 17):
        n = bits[l - 1]
        if n:
            valptr[l], mincode[l] = k, code
            code += n
            k += n
            maxcode[l] = code - 1
        code <<= 1
    hv = np.zeros(256, np.int32)
    hv[:len(vals)] = vals
    return np.concatenate([maxcode, valptr, mincode, hv]).astype(np.int32)


def _encode_table(bits, vals):
    """(ehufco, ehufsi) of 256 entries (jchuff.c's derived table)."""
    co, si = np.zeros(256, np.int32), np.zeros(256, np.int32)
    code, k = 0, 0
    for l in range(1, 17):
        for _ in range(bits[l - 1]):
            co[vals[k]], si[vals[k]] = code, l
            code += 1
            k += 1
        code <<= 1
    return co, si


# -------------------------------------------------------------- the C coder

_dec_fn = _enc_fn = None


def _c_fns():
    global _dec_fn, _enc_fn
    if _dec_fn is None:
        lib = _kernels.load("jpeg_huffman")
        dec, enc = lib.jpeg_decode_scan, lib.jpeg_encode_scan
        vp = ctypes.c_void_p
        dec.argtypes = [vp, ctypes.c_long, ctypes.c_int, vp, vp, vp, vp, vp, vp,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int]
        dec.restype = ctypes.c_long
        enc.argtypes = [vp, ctypes.c_long, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp,
                        ctypes.c_int, ctypes.c_int]
        enc.restype = ctypes.c_long
        _dec_fn, _enc_fn = dec, enc
    return _dec_fn, _enc_fn


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _i32(xs):
    return np.ascontiguousarray(xs, np.int32)


def huffman_decode(data: bytes, comps, mcux, mcuy, restart):
    """Decode a scan's entropy-coded bytes into each scan component's
    coefficient array, in place. comps: dicts with h, v (blocks an MCU),
    coef ((rows, cols, 64) int16), dc, ac (decode tables)."""
    dec, _ = _c_fns()
    buf = np.frombuffer(data, np.uint8)
    h, v = _i32([c["h"] for c in comps]), _i32([c["v"] for c in comps])
    cols = _i32([c["coef"].shape[1] for c in comps])
    rc = dec(buf.ctypes.data if len(buf) else None, len(buf), len(comps), h.ctypes.data,
             v.ctypes.data, cols.ctypes.data, _ptrs([c["coef"] for c in comps]),
             _ptrs([c["dc"] for c in comps]), _ptrs([c["ac"] for c in comps]), mcux, mcuy,
             restart)
    if rc == -1:
        raise ValueError("corrupt JPEG data: bad Huffman code")
    if rc == -2:
        raise ValueError("corrupt JPEG data: missing restart marker")


def huffman_encode(comps, mcux, mcuy) -> bytes:
    """Encode quantised coefficients in interleaved MCU order. comps: dicts
    with h, v, coef, dc and ac ((code, size) pairs of 256)."""
    _, enc = _c_fns()
    n_blocks = sum(c["coef"].shape[0] * c["coef"].shape[1] for c in comps)
    cap = 64 * 4 * n_blocks + 1024
    buf = np.empty(cap, np.uint8)
    h, v = _i32([c["h"] for c in comps]), _i32([c["v"] for c in comps])
    cols = _i32([c["coef"].shape[1] for c in comps])
    n = enc(buf.ctypes.data, cap, len(comps), h.ctypes.data, v.ctypes.data, cols.ctypes.data,
            _ptrs([c["coef"] for c in comps]), _ptrs([c["dc"][0] for c in comps]),
            _ptrs([c["dc"][1] for c in comps]), _ptrs([c["ac"][0] for c in comps]),
            _ptrs([c["ac"][1] for c in comps]), mcux, mcuy)
    if n < 0:
        raise RuntimeError("jpeg_encode_scan: output buffer too small")
    return buf[:n].tobytes()


# ---------------------------------------------------------- the plain coder

def huffman_decode_plain(data: bytes, comps, mcux, mcuy, restart):
    """The plain Python version of ``huffman_decode``."""
    pos, acc, nbits, marker = 0, 0, 0, False
    n = len(data)

    def bits(k):
        nonlocal pos, acc, nbits, marker
        while nbits < k:
            byte = 0
            if not marker and pos < n:
                byte = data[pos]
                if byte == 0xFF:
                    nxt = data[pos + 1] if pos + 1 < n else 0xD9
                    if nxt == 0:
                        pos += 2
                    else:
                        marker, byte = True, 0
                else:
                    pos += 1
            acc = (acc << 8) | byte
            nbits += 8
        nbits -= k
        val = (acc >> nbits) & ((1 << k) - 1)
        acc &= (1 << nbits) - 1
        return val

    def symbol(tab):
        maxcode, valptr, mincode, hv = tab[:17], tab[17:34], tab[34:51], tab[51:]
        code = bits(1)
        for l in range(1, 17):
            if code <= maxcode[l]:
                return int(hv[valptr[l] + code - mincode[l]])
            code = (code << 1) | bits(1)
        raise ValueError("corrupt JPEG data: bad Huffman code")

    def extend(x, t):
        return x - (1 << t) + 1 if x < (1 << (t - 1)) else x

    pred = [0] * len(comps)
    todo, rst = restart, 0
    for m in range(mcux * mcuy):
        if restart and todo == 0:
            acc, nbits, marker = 0, 0, False
            if data[pos:pos + 2] != bytes([0xFF, 0xD0 | rst]):
                raise ValueError("corrupt JPEG data: missing restart marker")
            pos += 2
            rst = (rst + 1) & 7
            pred = [0] * len(comps)
            todo = restart
        my, mx = divmod(m, mcux)
        for ci, c in enumerate(comps):
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    blk = c["coef"][my * c["v"] + by, mx * c["h"] + bx]
                    t = symbol(c["dc"])
                    pred[ci] += extend(bits(t), t) if t else 0
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        rs = symbol(c["ac"])
                        run, s = rs >> 4, rs & 15
                        if s == 0:
                            if run != 15:
                                break
                            k += 16
                            continue
                        k += run
                        if k > 63:
                            break
                        blk[NATURAL_ORDER[k]] = extend(bits(s), s)
                        k += 1
        if restart:
            todo -= 1


def huffman_encode_plain(comps, mcux, mcuy) -> bytes:
    """The plain Python version of ``huffman_encode``."""
    out = bytearray()
    acc, nbits = 0, 0

    def emit(code, size):
        nonlocal acc, nbits
        if size == 0:
            return
        acc = (acc << size) | (int(code) & ((1 << size) - 1))
        nbits += size
        while nbits >= 8:
            byte = (acc >> (nbits - 8)) & 0xFF
            nbits -= 8
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nbits) - 1

    pred = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, c in enumerate(comps):
                (dco, dsi), (aco, asi) = c["dc"], c["ac"]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        blk = c["coef"][my * c["v"] + by, mx * c["h"] + bx]
                        temp = int(blk[0]) - pred[ci]
                        pred[ci] = int(blk[0])
                        nb = abs(temp).bit_length()
                        emit(dco[nb], dsi[nb])
                        emit(temp - 1 if temp < 0 else temp, nb)
                        run = 0
                        for k in range(1, 64):
                            temp = int(blk[NATURAL_ORDER[k]])
                            if temp == 0:
                                run += 1
                                continue
                            while run > 15:
                                emit(aco[0xF0], asi[0xF0])
                                run -= 16
                            nb = abs(temp).bit_length()
                            emit(aco[(run << 4) + nb], asi[(run << 4) + nb])
                            emit(temp - 1 if temp < 0 else temp, nb)
                            run = 0
                        if run:
                            emit(aco[0], asi[0])
    emit(0x7F, 7)
    return bytes(out)


# -------------------------------------------------------------------- decode

def _scan_end(data: bytes, pos: int) -> int:
    """Where the entropy-coded data starting at `pos` ends: the first marker
    other than a stuffed 0xFF00 or an RSTn."""
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= len(data):
            return len(data)
        nxt = data[j + 1]
        if nxt == 0xFF:
            pos = j + 1
        elif nxt == 0 or 0xD0 <= nxt <= 0xD7:
            pos = j + 2
        else:
            return j


def _dht(body, dcs, acs):
    p = 0
    while p < len(body):
        tc, th = body[p] >> 4, body[p] & 15
        bits = list(body[p + 1:p + 17])
        vals = list(body[p + 17:p + 17 + sum(bits)])
        p += 17 + sum(bits)
        (acs if tc else dcs)[th] = _decode_table(bits, vals)


def _dqt(body, qts):
    p = 0
    while p < len(body):
        pq, tq = body[p] >> 4, body[p] & 15
        n = 128 if pq else 64
        vals = np.frombuffer(body[p + 1:p + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
        p += 1 + n
        qt = np.zeros(64, np.int64)
        qt[NATURAL_ORDER] = vals
        qts[tq] = qt


def _sof(body):
    prec, hgt, wid, nf = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise ValueError(f"JPEG sample precision {prec}: only 8-bit files are read")
    if hgt == 0:
        raise ValueError("JPEG with its height in a DNL marker is not read")
    if nf not in (1, 3):
        raise ValueError(f"JPEG with {nf} components: only 1 or 3 are read")
    comps = []
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    for c in comps:
        c["coef"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int16)
    return dict(height=hgt, width=wid, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy), comps


def decode_coefficients(data: bytes, coder: str = "c"):
    """Parse and entropy-decode a baseline JPEG: (frame, components). frame
    holds height, width and whether the components are RGB; each component
    its id, sampling factors, quantisation table and (rows, cols, 64) int16
    coefficients in the frame's MCU grid."""
    decode_scan = huffman_decode if coder == "c" else huffman_decode_plain
    if data[:2] != SOI:
        raise ValueError("not a JPEG file (no SOI marker)")
    qts, dcs, acs = {}, {}, {}
    frame, comps, restart, adobe, jfif = None, [], 0, None, False
    pos = 2
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            pos += 1                       # libjpeg skips junk between segments
            continue
        m = data[pos + 1]
        if m == 0xFF or m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 1 if m == 0xFF else 2
            continue
        if m == 0xD9:                      # EOI
            break
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body, end = data[pos + 4:pos + 2 + n], pos + 2 + n
        if m == 0xDB:
            _dqt(body, qts)
        elif m == 0xC4:
            _dht(body, dcs, acs)
        elif m in (0xC0, 0xC1):
            frame, comps = _sof(body)
        elif m in SOF_KINDS or 0xC9 <= m <= 0xCF and m != 0xCC:
            kind = SOF_KINDS.get(m, "arithmetic-coded")
            raise ValueError(f"{kind} JPEG (SOF{m - 0xC0}) is not read: only baseline "
                             "sequential Huffman files are")
        elif m == 0xCC:
            raise ValueError("arithmetic-coded JPEG (DAC) is not read")
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns, scan = body[0], []
            for i in range(ns):
                cs, t = body[1 + 2 * i], body[2 + 2 * i]
                c = next(c for c in comps if c["id"] == cs)
                scan.append(dict(coef=c["coef"], dc=dcs[t >> 4], ac=acs[t & 15],
                                 h=c["h"] if ns > 1 else 1, v=c["v"] if ns > 1 else 1))
            if ns > 1:
                mcux, mcuy = frame["mcux"], frame["mcuy"]
            else:                          # non-interleaved: the component's own blocks
                c = next(c for c in comps if c["id"] == body[1])
                mcux = -(-(-(-frame["width"] * c["h"] // frame["hmax"])) // 8)
                mcuy = -(-(-(-frame["height"] * c["v"] // frame["vmax"])) // 8)
            stop = _scan_end(data, end)
            decode_scan(data[end:stop], scan, mcux, mcuy, restart)
            end = stop
        pos = end
    if frame is None:
        raise ValueError("JPEG without a baseline frame header")
    for c in comps:
        c["qt"] = qts[c["tq"]]
    ids = [c["id"] for c in comps]
    frame["rgb"] = len(comps) == 3 and (adobe == 0 or (adobe is None and not jfif
                                                          and ids == [82, 71, 66]))
    return frame, comps


def _plane(c, frame):
    """A component's samples over its real extent: (rows, cols) uint8."""
    rows, cols = c["coef"].shape[:2]
    px = idct_islow(c["coef"], c["qt"])                      # (rows, cols, 8, 8)
    px = px.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
    hgt = -(-frame["height"] * c["v"] // frame["vmax"])
    wid = -(-frame["width"] * c["h"] // frame["hmax"])
    return px[:hgt, :wid]


def _full(c, frame):
    p = _plane(c, frame)
    fh, fv = frame["hmax"] // c["h"], frame["vmax"] // c["v"]
    return upsample(p, fh, fv)[:frame["height"], :frame["width"]]


def decode(data: bytes, mode: str = "unchanged", coder: str = "c") -> np.ndarray:
    """A baseline JPEG's pixels (see the module docstring for the modes);
    coder "plain" entropy-decodes in Python."""
    if mode not in ("gray", "bgr", "unchanged"):
        raise ValueError(f"mode {mode!r}: 'gray', 'bgr' or 'unchanged'")
    frame, comps = decode_coefficients(bytes(data), coder)
    if len(comps) == 1:
        y = _full(comps[0], frame)
        return np.repeat(y[..., None], 3, axis=-1) if mode == "bgr" else np.ascontiguousarray(y)
    if mode == "gray" and not frame["rgb"]:
        return np.ascontiguousarray(_full(comps[0], frame))
    a, b, c = (_full(comp, frame) for comp in comps)
    if frame["rgb"]:
        r, g, bl = a, b, c
    else:
        r, g, bl = ycc_to_rgb(a, b, c)
    if mode == "gray":
        # libjpeg's rgb_gray_convert, jdcolor.c: the Y of jccolor.c's tables
        return rgb_to_ycc(r, g, bl)[0]
    chans = (bl, g, r) if mode == "bgr" else (r, g, bl)
    return np.ascontiguousarray(np.stack(chans, axis=-1))


def read_jpeg(path, mode: str = "unchanged") -> np.ndarray:
    """The JPEG file at `path` (see ``decode``). A missing file raises
    FileNotFoundError."""
    with open(path, "rb") as f:
        return decode(f.read(), mode)


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


# -------------------------------------------------------------------- encode

def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's jpeg_set_quality (force_baseline) of a (64,) table."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows*8, cols*8) plane -> (rows, cols, 8, 8)."""
    return plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)


def _pad(plane, hgt, wid):
    """Repeat the last column and row out to (hgt, wid)."""
    plane = np.concatenate([plane, np.repeat(plane[:, -1:], wid - plane.shape[1], 1)], 1)
    return np.concatenate([plane, np.repeat(plane[-1:], hgt - plane.shape[0], 0)], 0)


def _quantised(plane, qt, rows_real, cols_real, rows, cols):
    """FDCT + quantisation of the real blocks; libjpeg's dummy blocks (zero
    AC, the DC of the block to the left, or above at the bottom edge) fill
    the padded MCU grid."""
    coef = np.zeros((rows, cols, 64), np.int16)
    coef[:rows_real, :cols_real] = fdct_quantize(_blocks(plane, rows_real, cols_real), qt)
    coef[:rows_real, cols_real:, 0] = coef[:rows_real, cols_real - 1:cols_real, 0]
    return coef


def encode(img: np.ndarray, quality: int = 95, coder: str = "c") -> bytes:
    """``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``'s
    bytes, for an (H, W) grey or (H, W, 3) BGR uint8 image; coder "plain"
    entropy-codes in Python."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode: (H, W) or (H, W, 3) uint8, not {img.shape} {img.dtype}")
    hgt, wid = img.shape[:2]
    if hgt < 1 or wid < 1 or hgt > 65535 or wid > 65535:
        raise ValueError(f"encode: image size {img.shape[:2]}")
    qy = quality_table(STD_LUMA_Q, quality)
    qc = quality_table(STD_CHROMA_Q, quality)
    if img.ndim == 2:
        planes, hv, tabs = [img], [(1, 1)], [0]
    else:
        y, cb, cr = rgb_to_ycc(img[..., 2], img[..., 1], img[..., 0])
        planes, hv, tabs = [y, cb, cr], [(2, 2), (1, 1), (1, 1)], [0, 1, 1]
    hmax, vmax = hv[0]
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    comps = []
    for plane, (h, v), t in zip(planes, hv, tabs):
        cw, ch = -(-wid * h // hmax), -(-hgt * v // vmax)     # the component's extent
        cols_real, rows_real = -(-cw // 8), -(-ch // 8)
        if (h, v) != (hmax, vmax):
            # h2v2_downsample of the image padded to whole 2x2 groups (the
            # columns to the blocks' width), then its last row repeated
            full = _pad(plane, 2 * ch, 2 * cols_real * 8).astype(np.int64)
            s = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
            bias = np.tile(np.array([1, 2], np.int64), cols_real * 4)[None, :]
            sub = _pad(((s + bias) >> 2).astype(np.uint8), rows_real * 8, cols_real * 8)
        else:
            sub = _pad(plane, rows_real * 8, cols_real * 8)
        rows, cols = mcuy * v, mcux * h
        coef = _quantised(sub, qy if t == 0 else qc, rows_real, cols_real, rows, cols)
        for r in range(rows_real, rows):       # dummy block rows: the DC above
            coef[r, :, 0] = coef[r - 1, np.arange(cols) // h * h + h - 1, 0]
        comps.append(dict(h=h, v=v, coef=coef, t=t))
    dc_tabs = [_encode_table(*DC_LUMA), _encode_table(*DC_CHROMA)]
    ac_tabs = [_encode_table(*AC_LUMA), _encode_table(*AC_CHROMA)]
    for c in comps:
        c["dc"], c["ac"] = dc_tabs[c["t"]], ac_tabs[c["t"]]
    scan = (huffman_encode if coder == "c" else huffman_encode_plain)(comps, mcux, mcuy)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [SOI, seg(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for t, qt in enumerate([qy, qc][:max(tabs) + 1]):
        out.append(seg(0xDB, bytes([t]) + bytes(qt[NATURAL_ORDER].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, hgt, wid, len(comps))
    for i, c in enumerate(comps):
        sof += bytes([i + 1, (c["h"] << 4) | c["v"], c["t"]])
    out.append(seg(0xC0, sof))
    for t in range(max(tabs) + 1):
        for cls, tab in ((0, (DC_LUMA, DC_CHROMA)[t]), (1, (AC_LUMA, AC_CHROMA)[t])):
            out.append(seg(0xC4, bytes([(cls << 4) | t] + tab[0] + tab[1])))
    sos = bytes([len(comps)])
    for i, c in enumerate(comps):
        sos += bytes([i + 1, (c["t"] << 4) | c["t"]])
    out.append(seg(0xDA, sos + bytes([0, 63, 0])))
    out.append(scan)
    out.append(EOI)
    return b"".join(out)


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """Write `img` as ``cv2.imwrite(path, img)`` writes a .jpg (its default
    quality is 95)."""
    data = encode(img, quality)
    with open(path, "wb") as f:
        f.write(data)
