"""Dataset loaders matching the reference's Examples binaries.

Port of ``iv_slam_tpu/io/datasets.py``.

KITTI (stereo_kitti.cc:618-816 LoadImages/WithGT), EuRoC
(stereo_euroc.cc timestamp lists), TUM RGB-D (rgbd_tum.cc associations),
and the Jackal session layout used by the batch scripts
(scripts/run_stereo_jackal_*.bash: <session>/img_left|img_right + heatmaps).

Loaders return lazy sequences of file paths + timestamps + optional GT
poses; image decoding happens in `load_gray` (io/png.py and io/jpeg.py, no
OpenCV).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import jpeg, png


def read_image(path: str, mode: str = "unchanged") -> np.ndarray:
    """A PNG or JPEG file, told apart by its signature, in `mode` ("gray":
    cv2's IMREAD_GRAYSCALE; "unchanged": imageio's array; see io/png.py and
    io/jpeg.py). A missing file raises FileNotFoundError."""
    with open(path, "rb") as f:
        data = f.read()
    if jpeg.is_jpeg(data):
        return jpeg.decode(data, mode)
    return png.decode_png(data, mode, path)


def load_gray(path: str) -> np.ndarray:
    """The image at `path` as (H, W) uint8: ``cv2.imread(path,
    IMREAD_GRAYSCALE)``'s result, which the JAX package takes where cv2 is
    installed, for a PNG or a JPEG file. A missing file raises
    FileNotFoundError."""
    return read_image(path, "gray")


@dataclass
class StereoSequence:
    left_paths: List[str]
    right_paths: List[str]
    timestamps: np.ndarray
    gt_poses: Optional[np.ndarray] = None   # (N, 4, 4) Twc
    names: List[str] = field(default_factory=list)

    def __len__(self):
        return len(self.left_paths)

    def __getitem__(self, i):
        return (
            load_gray(self.left_paths[i]),
            load_gray(self.right_paths[i]),
        ) + self.meta(i)

    def meta(self, i):
        """(timestamp, gt_pose, name) without decoding the images."""
        return (
            float(self.timestamps[i]),
            None if self.gt_poses is None else self.gt_poses[i],
            self.names[i] if self.names else os.path.basename(self.left_paths[i]),
        )


def load_kitti_stereo(
    data_path: str, gt_path: Optional[str] = None,
    start: int = 0, end: int = -1,
) -> StereoSequence:
    """KITTI odometry layout: image_0/%06d.png, image_1/, times.txt
    (stereo_kitti.cc:618-710)."""
    times = np.loadtxt(os.path.join(data_path, "times.txt"))
    n = len(times)
    end = n if end < 0 else min(end, n)
    idx = range(start, end)
    left = [os.path.join(data_path, "image_0", f"{i:06d}.png") for i in idx]
    right = [os.path.join(data_path, "image_1", f"{i:06d}.png") for i in idx]
    gt = None
    if gt_path:
        raw = np.loadtxt(gt_path).reshape(-1, 3, 4)
        gt = np.tile(np.eye(4, dtype=np.float32), (len(raw), 1, 1))
        gt[:, :3, :4] = raw
        gt = gt[start:end]
    return StereoSequence(
        left, right, times[start:end], gt,
        names=[f"{i:06d}.png" for i in idx],
    )


def load_euroc_stereo(
    data_path: str, timestamp_file: str, gt_path: Optional[str] = None
) -> StereoSequence:
    """EuRoC MAV layout: mav0/cam0/data/<ts>.png + timestamp list
    (stereo_euroc.cc LoadImages)."""
    with open(timestamp_file) as f:
        stamps = [ln.strip() for ln in f if ln.strip()]
    left = [os.path.join(data_path, "mav0/cam0/data", s + ".png") for s in stamps]
    right = [os.path.join(data_path, "mav0/cam1/data", s + ".png") for s in stamps]
    times = np.array([float(s) / 1e9 for s in stamps])
    return StereoSequence(left, right, times, None,
                          names=[s + ".png" for s in stamps])


def load_jackal_session(
    session_path: str, img_qual_path: Optional[str] = None
) -> StereoSequence:
    """Jackal sample-session layout (run_stereo_jackal_batch_inference.bash):
    <session>/image_0 + image_1 (KITTI-style numbering)."""
    left_dir = os.path.join(session_path, "image_0")
    names = sorted(os.listdir(left_dir))
    left = [os.path.join(left_dir, n) for n in names]
    right = [os.path.join(session_path, "image_1", n) for n in names]
    tfile = os.path.join(session_path, "times.txt")
    if os.path.exists(tfile):
        times = np.loadtxt(tfile)[: len(names)]
    else:
        times = np.arange(len(names)) * 0.1
    return StereoSequence(left, right, times, None, names=names)


def load_airsim_stereo(
    data_path: str, gt_path: Optional[str] = None,
    load_gt_depth: bool = False,
) -> StereoSequence:
    """AirSim session layout (stereo_airsim.cc): image_0/image_1 numbered
    frames, AirSim-format GT poses, optional PFM GT depth images
    (img_depth/*.pfm, stereo_airsim.cc:339-360)."""
    left_dir = os.path.join(data_path, "image_0")
    names = sorted(os.listdir(left_dir))
    left = [os.path.join(left_dir, n) for n in names]
    right = [os.path.join(data_path, "image_1", n) for n in names]
    tfile = os.path.join(data_path, "times.txt")
    times = (
        np.loadtxt(tfile)[: len(names)]
        if os.path.exists(tfile)
        else np.arange(len(names)) * 0.1
    )
    gt = None
    if gt_path and os.path.exists(gt_path):
        raw = np.loadtxt(gt_path)
        if raw.shape[1] == 12:  # KITTI-format rows
            gt = np.tile(np.eye(4, dtype=np.float32), (len(raw), 1, 1))
            gt[:, :3, :4] = raw.reshape(-1, 3, 4)
        elif raw.shape[1] >= 8:  # AirSim: t x y z qw qx qy qz
            from scipy.spatial.transform import Rotation

            gt = np.tile(np.eye(4, dtype=np.float32), (len(raw), 1, 1))
            q = raw[:, [5, 6, 7, 4]]  # -> [x, y, z, w]
            gt[:, :3, :3] = Rotation.from_quat(q).as_matrix()
            gt[:, :3, 3] = raw[:, 1:4]
    seq = StereoSequence(left, right, times, gt, names=names)
    if load_gt_depth:
        seq.depth_paths = [
            os.path.join(data_path, "img_depth", os.path.splitext(n)[0] + ".pfm")
            for n in names
        ]
    return seq


def load_gt_depth_pfm(path: str) -> Optional[np.ndarray]:
    from .pfm import read_pfm

    return read_pfm(path) if os.path.exists(path) else None


def load_tum_mono(data_path: str) -> StereoSequence:
    """TUM monocular layout: rgb.txt with `timestamp path` rows
    (mono_tum.cc LoadImages). Returns a StereoSequence whose right side
    mirrors the left (mono drivers ignore it)."""
    paths, times, names = [], [], []
    with open(os.path.join(data_path, "rgb.txt")) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) >= 2:
                times.append(float(parts[0]))
                paths.append(os.path.join(data_path, parts[1]))
                names.append(os.path.basename(parts[1]))
    return StereoSequence(paths, paths, np.array(times), None, names=names)


def load_tum_rgbd(data_path: str, association_file: str):
    """TUM RGB-D associations: timestamp rgb_path timestamp depth_path
    (rgbd_tum.cc LoadImages)."""
    rgb, depth, times = [], [], []
    with open(association_file) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 4 and not ln.startswith("#"):
                times.append(float(parts[0]))
                rgb.append(os.path.join(data_path, parts[1]))
                depth.append(os.path.join(data_path, parts[3]))
    return rgb, depth, np.array(times)
