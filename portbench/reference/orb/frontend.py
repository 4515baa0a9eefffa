"""One stereo frame through the plain frontend (Frame.cc:89-230): both
images extracted as one batch (the right one with a zero cost map, the
exact unweighted semantics), stereo matching, and the keypoints' quality
seeded from the left image's cost map."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import numerics, pyramid, stereo
from .config import ORBConfig
from .extractor import Keypoints, OrbExtractor


class StereoFrontend:
    """The frontend for one image geometry, ORB setting and camera.
    ``camera`` holds ``bf`` and ``baseline``; ``width``/``height`` are the
    image's."""

    def __init__(self, orb: ORBConfig, camera, height: int, width: int, device):
        self.cam = camera
        self.height, self.width = height, width
        self.extractor = OrbExtractor(orb, height, width)
        self.shapes = self.extractor.shapes
        self.device = device
        self.scale_factors = torch.as_tensor(orb.scale_factors(), dtype=torch.float32,
                                             device=device)
        self.level_widths = torch.as_tensor(
            np.array([s[1] for s in self.shapes], np.int32), device=device)
        self.level_offsets = torch.as_tensor(
            self.extractor.level_offsets.astype(np.int32), device=device)
        self.qual256 = numerics.quality_table(256.0).to(device)

    @torch.no_grad()
    def frame(self, pair: torch.Tensor, cost) -> SimpleNamespace:
        """(2, H, W) uint8 pair and the left image's (H, W) uint8 cost map
        (or None) -> the left keypoints ``kl``, the right ``kr``,
        ``u_right``, ``depth``, ``qual``, and ``finish`` and
        ``sad_centres``: the inputs of the orientation/descriptor stage and
        of the SAD slide, which the kernel counts read."""
        levels = pyramid.build_pyramid(pair, self.shapes)
        qlevels = None
        if cost is not None:
            qlevels = pyramid.build_pyramid(torch.stack([cost, torch.zeros_like(cost)]),
                                            self.shapes)
        kb, canvas = self.extractor.extract_from_pyramid_batched(levels, qlevels,
                                                                 return_canvas=True)
        kl = Keypoints(*(a[0] for a in kb))
        kr = Keypoints(*(a[1] for a in kb))
        _, flat_raw, flat_blur, yx_flat = self.extractor.finish_inputs(
            levels, kb.yx_level, kb.octave)
        rec = {}
        u_right, depth = stereo.match_stereo(
            kl.xy, kl.octave, kl.desc, kl.valid, kr.xy, kr.octave, kr.desc, kr.valid,
            canvas[0], canvas[1], self.level_offsets, self.level_widths,
            self.scale_factors, self.cam.bf, self.cam.baseline, record=rec)
        if cost is not None:
            xs = torch.clamp(torch.round(kl.xy[:, 0]).to(torch.int64), 0, self.width - 1)
            ys = torch.clamp(torch.round(kl.xy[:, 1]).to(torch.int64), 0, self.height - 1)
            qual = self.qual256[cost[ys, xs].to(torch.int64)]
        else:
            qual = torch.ones(kl.xy.shape[0], dtype=torch.float32, device=pair.device)
        return SimpleNamespace(
            kl=kl, kr=kr, u_right=u_right, depth=depth, qual=qual,
            finish=(flat_raw, flat_blur, yx_flat, kb.angle.reshape(-1)),
            sad_centres=rec["sad_centres"], canvas=canvas)
