"""Training-dataset writer (src/dataset_creator.cpp, include/dataset_creator.h).

Port of ``iv_slam_tpu/introspection/dataset_creator.py``. Accumulates
scored keypoints + image names in the reference's JSON schema and writes
heatmap / mask PNGs under ``<out>/bad_region_heatmap{,_mask}/<img_name>``
so the FCN training stack (either package's, or the reference's) consumes
the output unchanged:

  keypoints.json: {x_coord, y_coord, response, size, epipolar_err}
  img_names.json: {img_name, corresponding_keypt_id, corresponding_descriptor_id}
  descriptors.csv / descriptors_2.csv: one CSV row block per image

The PNGs are 8-bit grayscale, written by ``io/png.py::write_png`` (the
reference writes them with imageio): any PNG reader gets the same pixels.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..io.png import write_png


class DatasetCreator:
    def __init__(self, dataset_path: str):
        self.path = dataset_path
        os.makedirs(dataset_path, exist_ok=True)
        self.keypoints = {
            "x_coord": [], "y_coord": [], "response": [], "size": [],
            "epipolar_err": [],
        }
        self.img_names = {
            "img_name": [],
            "corresponding_keypt_id": [],
            "corresponding_descriptor_id": [],
        }
        self._keypt_counter = 0
        self._desc_counter = 0

    def append_keypoints(
        self,
        xy: np.ndarray,          # (N, 2)
        response: np.ndarray,    # (N,)
        size: np.ndarray,        # (N,)
        epipolar_err: np.ndarray,  # (N,)
    ):
        n = xy.shape[0]
        self.keypoints["x_coord"].extend(float(v) for v in xy[:, 0])
        self.keypoints["y_coord"].extend(float(v) for v in xy[:, 1])
        self.keypoints["response"].extend(float(v) for v in response)
        self.keypoints["size"].extend(float(v) for v in size)
        self.keypoints["epipolar_err"].extend(float(v) for v in epipolar_err)
        self.img_names["corresponding_keypt_id"].append(
            {"keypt_id": list(range(self._keypt_counter, self._keypt_counter + n))}
        )
        self._keypt_counter += n

    def append_descriptors(
        self, desc: np.ndarray, desc2: np.ndarray, img_name: str
    ):
        for fname, d in (("descriptors.csv", desc), ("descriptors_2.csv", desc2)):
            with open(os.path.join(self.path, fname), "a") as f:
                for row in d:
                    f.write(",".join(str(int(v)) for v in row) + "\n")
        self.img_names["img_name"].append(img_name)
        self.img_names["corresponding_descriptor_id"].append(
            {
                "descriptor_id": list(
                    range(self._desc_counter, self._desc_counter + desc.shape[0])
                )
            }
        )
        self._desc_counter += desc.shape[0]

    def save_bad_region_heatmap(self, img_name: str, heatmap: np.ndarray):
        self._save_png("bad_region_heatmap", img_name, heatmap)

    def save_bad_region_heatmap_mask(self, img_name: str, mask: np.ndarray):
        self._save_png("bad_region_heatmap_mask", img_name, mask)

    def _save_png(self, subdir: str, img_name: str, img: np.ndarray):
        d = os.path.join(self.path, subdir)
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, img_name), np.asarray(img, np.uint8))

    def save_to_file(self):
        with open(os.path.join(self.path, "keypoints.json"), "w") as f:
            json.dump(self.keypoints, f)
        with open(os.path.join(self.path, "img_names.json"), "w") as f:
            json.dump(self.img_names, f)
