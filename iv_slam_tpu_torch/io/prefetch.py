"""Decode-ahead stereo image loader.

Port of ``iv_slam_tpu/io/prefetch.py``. The reference decodes each stereo
pair synchronously on the tracking thread (stereo_kitti.cc:444-468:
cv::imread + optional cv::remap per frame). Here decode and rectification
run ahead of the consumer on a thread pool, so the driver's per-frame cost
is a queue pop. Decoding (zlib and the compiled row unfilter of
io/png.py, the compiled entropy decoder and numpy of io/jpeg.py) and
rectification (torch) release the interpreter lock for much of their work,
so the workers overlap the tracking thread.

The JAX package also has a native C++ worker pool (``native/src/
ivslam_io.cpp``), used where it is built. It decodes with OpenCV, which the
port does not use, so it has no counterpart: ``native_available()`` is
False, and the port follows the JAX package's thread-pool path: a missing
file raises FileNotFoundError from ``next()`` (the native loader yields
None instead).

Usage:
    with StereoPrefetcher(seq.left_paths, seq.right_paths,
                          rect_maps=(maps_l, maps_r)) as pf:
        for i in range(len(seq)):
            left, right = pf.next()
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

import numpy as np

from . import rectify
from .datasets import load_gray, read_image


def native_available() -> bool:
    """Whether the OpenCV worker pool is available: never in the port."""
    return False


class StereoPrefetcher:
    """Decode-ahead loader for a stereo path sequence, in order.

    rect_maps: ((m1x, m1y), (m2x, m2y)) float32 rectification maps per
    side (io/rectify.py `rectification_maps` output), or None entries to
    pass a side through unrectified.
    """

    def __init__(
        self,
        left_paths: Sequence[str],
        right_paths: Sequence[str],
        rect_maps=None,
        prefetch: int = 4,
        threads: int = 2,
        right_mode: str = "gray",
    ):
        """right_mode: "gray" (stereo right image), "unchanged" (16-bit
        RGB-D depth PNGs), or "skip" (monocular — next() yields None)."""
        if len(left_paths) != len(right_paths):
            raise ValueError("left/right path counts differ")
        if right_mode not in ("gray", "unchanged", "skip"):
            raise ValueError(f"right_mode {right_mode!r}")
        maps_l = maps_r = None
        if rect_maps is not None:
            maps_l, maps_r = rect_maps
        left_paths, right_paths = list(left_paths), list(right_paths)

        def job(i):
            left = load_gray(left_paths[i])
            if right_mode == "skip":
                right = None
            elif right_mode == "unchanged":
                right = read_image(right_paths[i], "unchanged")
            else:
                right = load_gray(right_paths[i])
            if maps_l is not None:
                left = rectify.remap(left, maps_l)
            if right is not None and maps_r is not None:
                right = rectify.remap(right, maps_r)
            return left, right

        self._n = len(left_paths)
        self._emitted = 0
        self._job = job
        self._pool = ThreadPoolExecutor(max_workers=max(threads, 1))
        self._futures = [self._pool.submit(job, i)
                         for i in range(min(max(prefetch, 1), self._n))]
        self._submitted = len(self._futures)

    def __len__(self):
        return self._n

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._emitted >= self._n:
            raise StopIteration("sequence exhausted")
        out = self._futures.pop(0).result()
        if self._submitted < self._n:
            self._futures.append(self._pool.submit(self._job, self._submitted))
            self._submitted += 1
        self._emitted += 1
        return out

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
