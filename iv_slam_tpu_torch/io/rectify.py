"""Stereo rectification maps and image remapping (the reference's
LEFT.*/RIGHT.* YAML blocks + cv::initUndistortRectifyMap / cv::remap flow:
stereo_kitti.cc:286-343, feature_evaluator.cpp:272-310 LoadRectificationMap
/ UnrectifyImage).

Port of ``iv_slam_tpu/io/rectify.py``. The maps are computed once on the
host in NumPy float64, by the JAX package's formula for a machine without
cv2 (inverse rectifying rotation, then the k1, k2, p1, p2, k3 distortion
model); they agree with ``cv2.initUndistortRectifyMap`` to rounding.

``remap`` reproduces ``cv2.remap`` with INTER_LINEAR or INTER_NEAREST,
float32 maps and BORDER_CONSTANT 0, bit for bit, on torch tensors, so it
runs wherever its inputs live (the loader calls it on the host, as the
reference does). OpenCV 4.11 and later interpolate 8- and 16-bit images
in float32: the source position's floor gives the four taps (0 outside
the image), its fraction (a, b) the weights, and the value is
``fma(b, f1 - f0, f0)`` with ``f0 = fma(a, p01 - p00, p00)`` and ``f1``
alike, rounded half to even and saturated. The fused multiply-adds are
those of OpenCV's AVX2 path, which x86 machines dispatch to (rounding the
product and the sum apart moves a rare pixel by one level). Earlier OpenCV
rounded the map to 1/32 pixel and weighted in 15-bit fixed point, which
differs by one level on many pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rectification_maps(
    K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray,
    width: int, height: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap(K, D, R, P[:3,:3], (w,h), CV_32F): for
    each rectified pixel, apply R^-1 then distort. float32 (h, w) maps."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    Pn = P[:3, :3]
    x = (u - Pn[0, 2]) / Pn[0, 0]
    y = (v - Pn[1, 2]) / Pn[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(R).T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    k1, k2, p1, p2, k3 = (list(D.ravel()) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    m1 = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    m2 = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return m1, m2


def load_rectification_from_yaml(doc: dict, side: str = "LEFT",
                                 strict: bool = True):
    """Pull LEFT.*/RIGHT.* rectification blocks out of a parsed reference
    settings YAML (EuRoC-style; Tracking.cc / stereo_euroc.cc; parse it with
    ``config._parse_opencv_yaml``) and return the side's maps.

    With ``strict`` (the default), a missing or incomplete block raises
    ValueError — mirroring the reference's CHECK/LOG(FATAL) semantics
    (Tracking.cc:536-539): silently running unrectified when the caller
    asked for rectification corrupts every downstream measurement.
    ``strict=False`` returns None instead.
    """
    def mat(key, rows, cols):
        node = doc.get(f"{side}.{key}")
        if node is None:
            return None
        data = node["data"] if isinstance(node, dict) else node
        return np.asarray(data, np.float64).reshape(rows, cols)

    K = mat("K", 3, 3)
    D_node = doc.get(f"{side}.D")
    D = (
        np.asarray(
            D_node["data"] if isinstance(D_node, dict) else D_node, np.float64
        ).ravel()
        if D_node is not None
        else None
    )
    R = mat("R", 3, 3)
    P = mat("P", 3, 4)
    h = doc.get(f"{side}.height")
    w = doc.get(f"{side}.width")
    missing = [k for k, v in
               (("K", K), ("D", D), ("R", R), ("P", P),
                ("height", h), ("width", w)) if v is None]
    if missing:
        if strict:
            raise ValueError(
                f"rectification requested but settings YAML is missing "
                f"{side}.{{{', '.join(missing)}}} "
                "(reference CHECKs these: Tracking.cc:536-539)")
        return None
    return rectification_maps(K, D, R, P, int(w), int(h))


_RANGE = {torch.uint8: (0, 255), torch.uint16: (0, 65535)}


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c as an FMA instruction gives it: the product of two
    float32 values is exact in float64; the sum is rounded to float64, then
    to float32, which differs from one rounding only where the first lands
    exactly on a float32 midpoint (never in the first stage, whose taps are
    integers and whose sums fit float64's 53 bits)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def remap_tensor(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
                 interpolation: str = "linear") -> torch.Tensor:
    """``cv2.remap(img, mx, my, INTER_LINEAR | INTER_NEAREST)`` with
    BORDER_CONSTANT 0 on tensors: img (H, W) or (H, W, C) uint8 or uint16,
    mx/my (h, w) float32 source columns and rows on img's device ->
    (h, w[, C]) of img's dtype."""
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"interpolation {interpolation!r}")
    if img.dtype not in _RANGE or img.ndim not in (2, 3):
        raise ValueError(f"remap: need an (H, W[, C]) uint8/uint16 image, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if mx.shape != my.shape or mx.dtype != torch.float32 or my.dtype != torch.float32:
        raise ValueError(f"remap: maps {tuple(mx.shape)} {mx.dtype}, {tuple(my.shape)} "
                         f"{my.dtype}; need two float32 maps of one shape")
    h, w = img.shape[:2]
    flat = img.reshape(h * w, -1).to(torch.float32)  # exact for 8- and 16-bit samples

    def tap(iy, ix):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = torch.where(inside, iy * w + ix, 0)
        v = flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[1])
        return torch.where(inside[..., None], v, 0.0)

    if interpolation == "nearest":
        out = tap(torch.round(my).to(torch.int64), torch.round(mx).to(torch.int64))
    else:
        fx, fy = torch.floor(mx), torch.floor(my)
        a, b = (mx - fx)[..., None], (my - fy)[..., None]
        ix, iy = fx.to(torch.int64), fy.to(torch.int64)
        p00, p01 = tap(iy, ix), tap(iy, ix + 1)
        p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
        f0 = _fma(a, p01 - p00, p00)
        f1 = _fma(a, p11 - p10, p10)
        lo, hi = _RANGE[img.dtype]
        out = torch.clamp(torch.round(_fma(b, f1 - f0, f0)), lo, hi)
    out = out.to(img.dtype)
    return out[..., 0] if img.ndim == 2 else out


def remap(img, maps, interpolation: str = "linear"):
    """``remap_tensor`` of a numpy image (on the host) or a tensor (on its
    device) by maps = (mx, my), numpy or tensors; returns the input's kind."""
    as_numpy = isinstance(img, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    mx, my = (torch.as_tensor(m, dtype=torch.float32, device=t.device) for m in maps)
    out = remap_tensor(t, mx, my, interpolation)
    return out.numpy() if as_numpy else out
