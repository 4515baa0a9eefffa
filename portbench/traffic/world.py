"""A textured ground plane viewed by a downward-looking stereo rig, rendered
by an exact homography warp, so ground-truth poses are exact and the stereo
geometry is the pinhole model's (frozen from the repository's test world).
"""

from __future__ import annotations

import cv2
import numpy as np


class PlaneWorld:
    def __init__(self, rng, tex_size=4096, res=40.0, fx=400.0, fy=400.0,
                 cx=160.0, cy=120.0, w=320, h=240, baseline=0.5):
        tex = rng.uniform(0, 255, size=(tex_size, tex_size)).astype(np.float32)
        for _ in range(6000):
            y, x = rng.integers(10, tex_size - 16, 2)
            tex[y:y + 8, x:x + 8] = rng.uniform(0, 255)
        # low-pass below Nyquist: descriptors must survive the sub-pixel
        # resampling of camera motion
        tex = cv2.GaussianBlur(tex, (9, 9), 2.0)
        self.tex = np.clip(tex, 0, 255).astype(np.uint8)
        self.res = res  # texture pixels per world metre
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.Kinv = np.linalg.inv(self.K)
        self.w, self.h = w, h
        self.baseline = baseline

    def render(self, Twc: np.ndarray) -> np.ndarray:
        """The (h, w) uint8 view of the camera at camera-to-world pose Twc."""
        R = Twc[:3, :3]
        C = Twc[:3, 3]
        uu, vv = np.meshgrid(np.arange(self.w), np.arange(self.h))
        rays = np.stack([uu, vv, np.ones_like(uu)], axis=-1).astype(np.float32)
        rays = rays @ self.Kinv.T @ R.T  # world-frame ray directions
        lam = -C[2] / rays[..., 2]
        X = C[None, None, :] + lam[..., None] * rays
        tx = (X[..., 0] * self.res + self.tex.shape[1] / 2).astype(np.float32)
        ty = (X[..., 1] * self.res + self.tex.shape[0] / 2).astype(np.float32)
        return cv2.remap(self.tex, tx, ty, cv2.INTER_LINEAR, borderMode=cv2.BORDER_WRAP)

    def render_stereo(self, Twc: np.ndarray):
        """(left, right): the right camera displaced by the baseline along
        the camera's x axis."""
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([self.baseline, 0, 0], np.float32)
        return self.render(Twc), self.render(Twc_r)


def camera_pose(t_xyz, height=10.0, yaw=0.0) -> np.ndarray:
    """Twc of a camera at t_xyz + altitude, optical axis down at the plane
    (camera z toward -world z), x along world x turned by yaw."""
    Twc = np.eye(4, dtype=np.float32)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rwc = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, -1.0]], np.float32)
    Rwc[:, 1] *= -1  # right-handed
    Twc[:3, :3] = Rwc
    Twc[:3, 3] = [t_xyz[0], t_xyz[1], height]
    return Twc
