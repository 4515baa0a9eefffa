"""Augmented-reality overlay — the reference's ROS AR demo, headless.

The reference ships an AR node (Examples/ROS/ORB_SLAM2/src/AR/
ros_mono_ar.cc + ViewerAR.cc): ViewerAR::DetectPlane (ViewerAR.cc:392-509)
RANSAC-fits a plane to well-observed map points, Plane::Recompute
(ViewerAR.cc:520-570) refines it over the inliers and anchors a local
frame at their centroid, and DrawCube/DrawPlane (ViewerAR.cc:336-390)
render a virtual cube + grid with the live camera pose in a Pangolin/GL
window. A headless GPU host has no GL; this module reproduces the geometry —
the same RANSAC scoring (20th-percentile distance, 1.4x inlier gate, >5
observations, >=50 points), the same centroid-anchored plane frame — and
draws the wireframe overlay onto saved frames, matching the headless
save-to-file contract of slam/viewer.py.

Port of ``iv_slam_tpu/slam/ar.py``: the same RANSAC with the same numpy
generator (the same seed finds the same plane), drawn with
``io/raster.py``'s anti-aliased lines (cv2's LINE_AA). It reads the
port's host MapStore.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..io import raster


@dataclasses.dataclass
class ARPlane:
    """Plane frame: origin at the inlier centroid, z axis = plane normal
    oriented toward the detecting camera (Plane::Recompute semantics)."""

    origin: np.ndarray          # (3,) world
    R: np.ndarray               # (3, 3) world <- plane axes (z = normal)
    inliers: np.ndarray         # indices into the candidate point array

    @property
    def normal(self) -> np.ndarray:
        return self.R[:, 2]

    def Twp(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.R
        T[:3, 3] = self.origin
        return T


def _fit_plane_lsq(pts: np.ndarray):
    """Total-least-squares plane through pts: (unit normal, centroid)."""
    c = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    n = vt[-1]
    return n / np.linalg.norm(n), c


def detect_plane(
    points: np.ndarray,
    n_obs: np.ndarray,
    Tcw: np.ndarray,
    iterations: int = 50,
    rng: Optional[np.random.Generator] = None,
    min_points: int = 50,
    min_obs: int = 5,
) -> Optional[ARPlane]:
    """ViewerAR::DetectPlane (ViewerAR.cc:392-509): RANSAC a dominant
    plane from the map points with more than `min_obs` observations.

    Hypotheses are 3-point planes; each is scored by the 20th-percentile
    (at least 20th-smallest) point-plane distance, the best hypothesis
    gates inliers at 1.4x its score, and the final plane is re-fit over
    the inliers with its frame anchored at their centroid, normal flipped
    toward the camera.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    points = np.asarray(points, np.float64)
    keep = np.asarray(n_obs) > min_obs
    cand = points[keep]
    cand_idx = np.nonzero(keep)[0]
    N = len(cand)
    if N < min_points:
        return None

    # batched RANSAC: all hypothesis planes + the full distance matrix at
    # once (the reference's per-iteration loop, vectorized)
    sel = np.stack([rng.choice(N, size=3, replace=False)
                    for _ in range(iterations)])        # (it, 3)
    tri = cand[sel]                                     # (it, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])  # (it, 3)
    norm = np.linalg.norm(n, axis=1)
    ok = norm > 1e-12
    n = np.where(ok[:, None], n / np.maximum(norm, 1e-12)[:, None], 0.0)
    d = -np.einsum("ij,ij->i", n, tri[:, 0])            # (it,)
    dist = np.abs(cand @ n.T + d[None, :])              # (N, it)
    dist[:, ~ok] = np.inf
    nth = max(int(0.2 * N), 20)
    nth = min(nth, N - 1)
    score = np.partition(dist, nth, axis=0)[nth]        # (it,)
    best = int(np.argmin(score))
    if not np.isfinite(score[best]):
        return None
    # 1.4x the best 20th-percentile distance, floored so an exactly
    # coplanar cloud (synthetic data) still admits its inliers
    scale = float(np.abs(cand).max()) + 1.0
    th = max(1.4 * float(score[best]), 1e-6 * scale)
    inl = dist[:, best] < th
    if inl.sum() < 3:
        return None

    normal, centroid = _fit_plane_lsq(cand[inl])
    # orient the normal toward the camera center (Plane::Recompute flips
    # it so the cube sits on the visible side)
    Tcw = np.asarray(Tcw, np.float64)
    cam_center = -Tcw[:3, :3].T @ Tcw[:3, 3]
    if np.dot(normal, cam_center - centroid) < 0:
        normal = -normal
    # plane frame: z = normal; x = any perpendicular
    a = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(a, normal)) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    x = np.cross(a, normal)
    x /= np.linalg.norm(x)
    y = np.cross(normal, x)
    R = np.stack([x, y, normal], axis=1)
    return ARPlane(
        origin=centroid.astype(np.float32),
        R=R.astype(np.float32),
        inliers=cand_idx[inl],
    )


# cube corners in the plane frame: base square on the plane, extruded
# along +z (the plane normal); unit cube scaled by `size`
_CUBE_CORNERS = np.array(
    [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0],
     [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.5, 0.5, 1.0], [-0.5, 0.5, 1.0]],
    np.float32,
)
_CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def cube_corners_world(plane: ARPlane, size: float = 1.0) -> np.ndarray:
    """(8, 3) world-space corners of a cube of side `size` resting on the
    plane at its origin (ViewerAR::DrawCube geometry, ViewerAR.cc:336-355)."""
    return plane.origin[None, :] + (_CUBE_CORNERS * size) @ plane.R.T


def project_points(K: np.ndarray, Tcw: np.ndarray, pts_w: np.ndarray):
    """Project world points; returns ((M, 2) pixels, (M,) in-front mask)."""
    pc = pts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    front = z > 1e-6
    zs = np.where(front, z, 1.0)
    u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
    return np.stack([u, v], axis=1), front


def plane_grid_world(plane: ARPlane, ndivs: int = 4,
                     div_size: float = 0.5) -> list:
    """Line segments (world (3,) pairs) of the reference's plane grid
    (ViewerAR::DrawPlane, ViewerAR.cc:357-390)."""
    half = ndivs * div_size
    segs = []
    for i in range(-ndivs, ndivs + 1):
        t = i * div_size
        for p0, p1 in (
            ((t, -half, 0.0), (t, half, 0.0)),
            ((-half, t, 0.0), (half, t, 0.0)),
        ):
            a = plane.origin + plane.R @ np.asarray(p0, np.float32)
            b = plane.origin + plane.R @ np.asarray(p1, np.float32)
            segs.append((a, b))
    return segs


def draw_ar_overlay(
    img_gray: np.ndarray,
    Tcw: np.ndarray,
    K: np.ndarray,
    plane: ARPlane,
    cube_size: float = 1.0,
    draw_grid: bool = True,
) -> np.ndarray:
    """Render the virtual cube (+ plane grid) into a BGR copy of the frame
    with the current camera pose — the headless DrawCube/DrawPlane."""
    img = raster.gray2bgr(img_gray)
    h, w = img.shape[:2]

    def px(p):
        return np.rint(np.asarray(p, np.float64)).astype(np.int64)   # round(), to even

    if draw_grid:
        a2, b2 = [], []
        for a, b in plane_grid_world(plane):
            p2, front = project_points(K, Tcw, np.stack([a, b]))
            if front.all():
                a2.append(p2[0])
                b2.append(p2[1])
        if a2:
            raster.lines_aa(img, px(a2), px(b2), [(80, 200, 80)], 1)
    corners = cube_corners_world(plane, cube_size)
    p2, front = project_points(K, Tcw, corners)
    if front.all() and (np.abs(p2) < 4 * max(h, w)).all():
        i, j = np.array(_CUBE_EDGES).T
        colors = [(0, 0, 230) if a < 4 and b < 4 else (230, 120, 0) for a, b in _CUBE_EDGES]
        raster.lines_aa(img, px(p2[i]), px(p2[j]), colors, 2)
    return img


class ARRenderer:
    """Per-frame AR driver state: detects the plane once enough
    well-observed map points exist, then overlays every tracked frame
    (the ViewerAR::Run loop, ViewerAR.cc:120-260, without the menu)."""

    def __init__(self, K: np.ndarray, cube_size: float = 1.0,
                 iterations: int = 50, seed: int = 0, min_obs: int = 5,
                 patience: int = 30):
        self.K = np.asarray(K, np.float32)
        self.cube_size = cube_size
        self.iterations = iterations
        self.plane: Optional[ARPlane] = None
        self._rng = np.random.default_rng(seed)
        # the reference gate is fixed (>5 obs, >=50 points) because the AR
        # node runs on long live streams; on short sequences that never
        # fires, so relax the observation gate every `patience` misses
        self.min_obs = min_obs
        self.patience = patience
        self._misses = 0

    def try_detect(self, map_store, Tcw) -> bool:
        n = map_store.n_points
        if n == 0:
            return False
        alive = map_store.pt_alive[:n]
        pts = map_store.pt_pos[:n][alive]
        obs = np.array(
            [len(map_store.pt_obs[i]) for i in np.nonzero(alive)[0]],
            np.int32,
        )
        plane = detect_plane(pts, obs, Tcw, self.iterations, self._rng,
                             min_obs=self.min_obs)
        if plane is not None:
            self.plane = plane
            return True
        self._misses += 1
        if self._misses >= self.patience and self.min_obs > 0:
            self.min_obs = max(self.min_obs - 2, 0)
            self._misses = 0
        return False

    def render(self, img_gray, Tcw, map_store=None):
        """Returns the overlay frame (BGR), or a plain BGR conversion
        while no plane has been detected yet."""
        if self.plane is None and map_store is not None and Tcw is not None:
            self.try_detect(map_store, Tcw)
        if self.plane is None or Tcw is None:
            return raster.gray2bgr(img_gray)
        return draw_ar_overlay(img_gray, Tcw, self.K, self.plane,
                               self.cube_size)
