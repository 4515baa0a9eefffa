"""PFM float-image reader/writer (io_access.h:57-180 equivalent).

Port of ``iv_slam_tpu/io/pfm.py``. Used for AirSim ground-truth depth
images (stereo_airsim.cc:339-360).
"""

from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path}")
        color = header == "PF"
        dims = f.readline().decode("ascii").strip().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode("ascii").strip())
        little_endian = scale < 0
        count = w * h * (3 if color else 1)
        data = np.fromfile(f, "<f4" if little_endian else ">f4", count)
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    # PFM stores rows bottom-to-top
    return np.flipud(img).copy()


def write_pfm(path: str, img: np.ndarray, scale: float = 1.0):
    img = np.asarray(img, np.float32)
    color = img.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # little-endian
        np.flipud(img).astype("<f4").tofile(f)
