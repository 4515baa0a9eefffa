"""A closed circuit for a stereo session: an ellipse driven at a speed that
rises from its slowest at the two ends to its fastest on the two long
sides, the yaw wobbling a whole number of times a lap. Pose n equals pose
0 and the last step equals the first, so laps replay with no jump in
motion."""

from __future__ import annotations

import numpy as np

from .world import camera_pose


def speeds(n: int, v_min: float, v_max: float) -> np.ndarray:
    """Metres travelled from frame i to i + 1 (two slow ends, two fast sides)."""
    i = np.arange(n)
    return 0.5 * (v_min + v_max) - 0.5 * (v_max - v_min) * np.cos(4.0 * np.pi * i / n)


def lap(n: int, v_min: float, v_max: float, aspect: float, height: float,
        yaw_amp: float, yaw_waves: int):
    """The n poses Twc of one lap. The ellipse's semi-axes a, a / aspect are
    fixed by its perimeter, the sum of the speeds."""
    v = speeds(n, v_min, v_max)
    s = np.concatenate([[0.0], np.cumsum(v)])            # arc length at frame i
    phi = np.linspace(0.0, 2.0 * np.pi, 20001)
    unit = np.stack([np.cos(phi), np.sin(phi) / aspect], 1)   # a = 1
    arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(unit, axis=0), axis=1))])
    a = s[-1] / arc[-1]
    ph = np.interp(s[:-1], arc * a, phi)
    # start at the end of the major axis, so the lap's seam is slow
    xy = np.stack([a * (np.cos(ph) - 1.0), a / aspect * np.sin(ph)], 1)
    yaw = yaw_amp * np.sin(2.0 * np.pi * yaw_waves * np.arange(n) / n)
    return [camera_pose(np.array([x, y, 0.0], np.float32), height=height, yaw=float(w))
            for (x, y), w in zip(xy, yaw)]
