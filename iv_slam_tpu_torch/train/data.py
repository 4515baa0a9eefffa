"""Training dataset for the introspection FCN.

Port of ``iv_slam_tpu/train/data.py``, the equivalent of
ImageQualityDataset (data_loader/load_images.py:113-266): pairs raw session
images (<raw_root>/<session %05d>/image_0/<name>) with the generated
bad-region heatmaps and masks, crops the input image to the heatmap's
cropped size, resizes it to the network input and the targets to 1/8 of
it (TARGET_DOWNSAMPLING), grey -> 3 channels, ImageNet normalization;
optional binarization at 180 (load_images.py:38).

The package reads images with ``io/datasets.py::read_image`` (PNG or JPEG,
imageio's arrays), and resizes uint8 images with ``resize_linear``: OpenCV's INTER_LINEAR
geometry (half-pixel centres, edge pixels repeated, no antialiasing),
computed in float64 and rounded half up. OpenCV computes in fixed point
(11-bit weights), so a pixel may come out one grey level from cv2's (the
JAX package resizes with cv2): ``tests/test_torch_train_data.py`` bounds
it. The post-processing dataset reads the reference's ``.jpg`` network
outputs where no PNG of the name exists, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io.datasets import read_image
from ..models.introspection import IMAGENET_MEAN, IMAGENET_STD

TARGET_DOWNSAMPLING = 8
BINARIZE_THRESH = 180


def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: source index pairs and the
    weight of the second, edge pixels repeated."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    frac[i0 < 0] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    frac[i0 >= src - 1] = 0.0
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) for uint8
    (H, W) or (H, W, C) images, in float64 rounded half up (within one grey
    level of cv2's fixed point)."""
    src = img.astype(np.float64)
    y0, y1, fy = _linear_taps(img.shape[0], h)
    x0, x1, fx = _linear_taps(img.shape[1], w)
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    rows = src[y0] * (1.0 - fy) + src[y1] * fy
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


@dataclass
class Sample:
    image: np.ndarray    # (H, W, 3) float32 normalized
    target: np.ndarray   # (H/8, W/8, 1) float32 in [0, 1]
    mask: np.ndarray     # (H/8, W/8, 1) float32 {0, 1}
    session: int
    name: str


class ImageQualityDataset:
    def __init__(
        self,
        data_root: str,              # sessions of generated_training_data
        raw_img_root: str,
        sessions: Sequence[int],
        input_hw: Tuple[int, int] = (512, 512),
        binarize: bool = False,
        use_masks: bool = True,
    ):
        self.entries: List[Tuple[int, str, str, Optional[str], str]] = []
        self.input_hw = input_hw
        self.binarize = binarize
        for s in sessions:
            sdir = os.path.join(data_root, f"{s:05d}", "generated_training_data")
            hm_dir = os.path.join(sdir, "bad_region_heatmap")
            mask_dir = os.path.join(sdir, "bad_region_heatmap_mask")
            raw_dir = os.path.join(raw_img_root, f"{s:05d}", "image_0")
            if not os.path.isdir(hm_dir):
                continue
            for name in sorted(os.listdir(hm_dir)):
                mask_path = os.path.join(mask_dir, name)
                self.entries.append((
                    s, os.path.join(raw_dir, name), os.path.join(hm_dir, name),
                    mask_path if (use_masks and os.path.exists(mask_path)) else None, name))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Sample:
        session, raw_path, hm_path, mask_path, name = self.entries[i]
        raw = read_image(raw_path)
        if raw.ndim == 2:
            raw = np.stack([raw] * 3, axis=-1)
        hm = read_image(hm_path)
        if hm.ndim == 3:
            hm = hm[..., 0]
        # crop raw to the heatmap's (cropped) size (train_modular.py:189-231)
        raw = raw[: hm.shape[0], : hm.shape[1]]
        ih, iw = self.input_hw
        img = resize_linear(raw, iw, ih).astype(np.float32) / 255.0
        img = (img - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)

        th, tw = ih // TARGET_DOWNSAMPLING, iw // TARGET_DOWNSAMPLING
        tgt = resize_linear(hm, tw, th).astype(np.float32) / 255.0
        if self.binarize:
            tgt = (tgt * 255.0 > BINARIZE_THRESH).astype(np.float32)
        if mask_path is not None:
            m = read_image(mask_path)
            if m.ndim == 3:
                m = m[..., 0]
            mask = (resize_linear(m, tw, th) > 127).astype(np.float32)
        else:
            mask = np.ones((th, tw), np.float32)
        return Sample(image=img.astype(np.float32), target=tgt[..., None],
                      mask=mask[..., None], session=session, name=name)

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle=True,
                prefetch: int = 2) -> Iterator[dict]:
        """Batches of stacked samples in `rng`'s order, read by one prefetch
        thread (the reference's DataLoader workers, train_modular.py:264-267,
        collapsed to one); a last partial batch is dropped."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)

        def producer():
            try:
                for start in range(0, len(order) - batch_size + 1, batch_size):
                    samples = [self[i] for i in order[start:start + batch_size]]
                    q.put(dict(image=np.stack([s.image for s in samples]),
                               target=np.stack([s.target for s in samples]),
                               mask=np.stack([s.mask for s in samples])))
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


@dataclass
class PPSample:
    image: np.ndarray           # (H, W, C) uint8, cropped to heatmap size
    score_img: np.ndarray       # (H, W, 1) uint8 GT bad-region heatmap
    network_output: np.ndarray  # (H, W, 1) uint8 predicted cost map
    keypt_xy: np.ndarray        # (K, 2) float keypoint coords in this image
    keypt_response: np.ndarray  # (K,)
    keypt_epipolar_err: np.ndarray  # (K,)
    session: int
    name: str


class ImageQualityDatasetPP:
    """Post-processing/eval dataset (data_loader/load_images_pp.py): raw
    images with the GT bad-region heatmap, the network's predicted cost map
    and the image's keypoints (coords, response, epipolar error) from
    keypoints.json / img_names.json: the inputs of the retained-data
    precision curves (testing/eval_model_outputs.py:48-60)."""

    def __init__(
        self,
        data_root: str,          # sessions of generated_training_data
        raw_img_root: str,
        sessions: Sequence[int],
        network_output_root: str,
        raw_img_folder: str = "image_0",
        session_prefix_length: int = 5,
    ):
        fmt = f"{{0:0{session_prefix_length}d}}"
        self.entries = []
        for s in sessions:
            sdir = os.path.join(data_root, fmt.format(s), "generated_training_data")
            kp_path = os.path.join(sdir, "keypoints.json")
            names_path = os.path.join(sdir, "img_names.json")
            if not (os.path.exists(kp_path) and os.path.exists(names_path)):
                continue
            with open(kp_path) as f:
                kp = json.load(f)
            with open(names_path) as f:
                names = json.load(f)
            kx = np.asarray(kp["x_coord"], np.float32)
            ky = np.asarray(kp["y_coord"], np.float32)
            kr = np.asarray(kp["response"], np.float32)
            ke = np.asarray(kp["epipolar_err"], np.float32)
            for name, corr in zip(names["img_name"], names["corresponding_keypt_id"]):
                ids = np.asarray(corr["keypt_id"], int)
                self.entries.append(dict(
                    session=s, name=name,
                    raw=os.path.join(raw_img_root, fmt.format(s), raw_img_folder, name),
                    score=os.path.join(sdir, "bad_region_heatmap", name),
                    net=os.path.join(network_output_root, fmt.format(s), name),
                    xy=np.stack([kx[ids], ky[ids]], axis=1), response=kr[ids],
                    err=ke[ids]))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> PPSample:
        e = self.entries[i]
        raw = read_image(e["raw"])
        if raw.ndim == 2:
            raw = raw[..., None]
        score = read_image(e["score"])
        if score.ndim == 3:
            score = score[..., 0]
        net_path = e["net"]
        if not os.path.exists(net_path):
            # the reference stores network outputs as .jpg
            net_path = os.path.splitext(net_path)[0] + ".jpg"
        net = read_image(net_path)
        if net.ndim == 3:
            net = net[..., 0]
        h, w = score.shape
        return PPSample(image=raw[:h, :w], score_img=score[..., None],
                        network_output=net[:h, :w, None], keypt_xy=e["xy"],
                        keypt_response=e["response"], keypt_epipolar_err=e["err"],
                        session=e["session"], name=e["name"])


def retention_curve(pred_cost: np.ndarray, epipolar_err: np.ndarray,
                    n_points: int = 10) -> list:
    """Retained-data precision curve (eval_model_outputs.py:48-60): sort
    keypoints by predicted cost ascending; for each retention fraction
    report the mean GT epipolar error of the retained set."""
    order = np.argsort(pred_cost)
    out = []
    for f in np.linspace(1.0 / n_points, 1.0, n_points):
        k = max(int(f * len(order)), 1)
        out.append(dict(retained=float(f), mean_err=float(np.mean(epipolar_err[order[:k]]))))
    return out
