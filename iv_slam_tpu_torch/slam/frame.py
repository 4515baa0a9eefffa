"""Per-frame data bundle + the stereo frontend that fills it.

Port of ``iv_slam_tpu/slam/frame.py`` (``Frame`` and ``StereoFrontend``):
the reference's Frame stereo constructor (Frame.cc:89-230) — ORB
extraction on both images, weighted by an introspection cost map when one
is given or an FCN is attached, stereo matching, quality-score seeding.
Both images go through the extractor as one batch; the whole frame,
the FCN included, is queued on the device's current stream with no host
synchronisation, so ``submit`` returns at once and ``collect`` waits for
one (N, 7) download.

Host-side state (pose, map-point associations, outlier flags) lives in
NumPy; the padded keypoint tensors stay on the device for the downstream
matchers and optimizers.

Not ported yet: ``MonoFrontend`` and ``RGBDFrontend`` (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import numerics
from ..config import Config
from ..models.introspection import inference_cost_map
from ..ops import pyramid as pyr
from ..ops import stereo
from ..ops.extractor import Keypoints, OrbExtractor
from . import resolve_device


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    kp: Keypoints                    # device tensors, capacity N
    u_right: np.ndarray              # (N,) float32, -1 = no stereo match
    depth: np.ndarray                # (N,) float32, -1 = none
    qual_score: np.ndarray           # (N,) float32 introspection quality
    pose: Optional[np.ndarray] = None      # (4, 4) Tcw
    map_pt: Optional[np.ndarray] = None    # (N,) int32 map-point id or -1
    outlier: Optional[np.ndarray] = None   # (N,) bool
    ref_kf: int = -1
    gt_pose: Optional[np.ndarray] = None   # (4, 4) Twc ground truth
    gt_cov: Optional[np.ndarray] = None    # (6, 6)
    # per-keypoint GT depth (mvKeysGTDepth, Frame.cc:152-191); -1 where
    # unavailable
    kp_gt_depth: Optional[np.ndarray] = None
    img_name: str = ""
    # cached numpy views of the keypoint arrays (host bookkeeping)
    xy: np.ndarray = None
    octave: np.ndarray = None
    valid: np.ndarray = None
    # defer=True keeps the host views on the device (u_right/depth/
    # qual_score stay tensors) until materialize()
    defer: bool = False
    # (N, 7) device tensor [x, y, octave, valid, u_right, depth, qual] kept
    # for deferred frames so materializing is one download
    host_pack: object = None
    # device-resident copies of u_right/depth/qual_score, kept past
    # materialization (the fused tracking step reads these)
    ur_dev: object = None
    depth_dev: object = None
    qual_dev: object = None
    _angle: np.ndarray = None
    _desc: np.ndarray = None

    def __post_init__(self):
        n = self.u_right.shape[0]
        if self.map_pt is None:
            self.map_pt = np.full(n, -1, np.int32)
        if self.outlier is None:
            self.outlier = np.zeros(n, bool)
        if self.xy is None and not self.defer:
            self._materialize(())

    def materialize(self, extras=()):
        """Download the host views (once) plus any `extras` device tensors;
        returns the extras as numpy."""
        if self.xy is not None:
            return tuple(e.cpu().numpy() for e in extras)
        return self._materialize(extras)

    def _materialize(self, extras):
        if self.host_pack is not None:
            _unpack_host(self, self.host_pack.cpu().numpy())
        else:
            self.xy = self.kp.xy.cpu().numpy()
            self.octave = self.kp.octave.cpu().numpy()
            self.valid = self.kp.valid.cpu().numpy()
            for f in ("u_right", "depth", "qual_score"):
                v = getattr(self, f)
                if isinstance(v, torch.Tensor):
                    setattr(self, f, v.cpu().numpy())
        return tuple(e.cpu().numpy() for e in extras)

    @property
    def desc(self) -> np.ndarray:
        """Host descriptor view — downloaded lazily: only keyframes need
        descriptors on the host."""
        if self._desc is None:
            self._desc = self.kp.desc.cpu().numpy()
        return self._desc

    @property
    def angle(self) -> np.ndarray:
        if self._angle is None:
            self._angle = self.kp.angle.cpu().numpy()
        return self._angle

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    def set_pose(self, T: np.ndarray):
        self.pose = np.asarray(T, np.float32).copy()

    def camera_center(self) -> np.ndarray:
        R = self.pose[:3, :3]
        return -R.T @ self.pose[:3, 3]

    def unproject_stereo(self, i: int, fx, fy, cx, cy) -> Optional[np.ndarray]:
        """Backproject keypoint i via its stereo depth into world coords
        (Frame::UnprojectStereo, Frame.cc:958-977)."""
        z = float(self.depth[i])
        if z <= 0:
            return None
        u, v = self.xy[i]
        x = (u - cx) * z / fx
        y = (v - cy) * z / fy
        pc = np.array([x, y, z, 1.0], np.float32)
        Twc = np.linalg.inv(self.pose)
        return (Twc @ pc)[:3]


def _unpack_host(fr: Frame, pack: np.ndarray) -> None:
    """Split the (N, 7) host pack into the frame's numpy views."""
    fr.xy = np.ascontiguousarray(pack[:, 0:2])
    fr.octave = pack[:, 2].astype(np.int32)
    fr.valid = pack[:, 3] != 0.0
    fr.u_right = np.ascontiguousarray(pack[:, 4])
    fr.depth = np.ascontiguousarray(pack[:, 5])
    fr.qual_score = np.ascontiguousarray(pack[:, 6])


@dataclasses.dataclass
class FrameHandle:
    """The queued device work of one frame (``StereoFrontend.submit``)."""

    kl: Keypoints
    kr: Keypoints
    u_right: torch.Tensor
    depth: torch.Tensor
    qual: torch.Tensor
    host_pack: torch.Tensor
    # pinned host copy of host_pack in flight and its completion event, set
    # by prefetch_host
    host_copy: Optional[torch.Tensor] = None
    copied: Optional[torch.cuda.Event] = None


class StereoFrontend:
    """Builds Frames from stereo pairs on one device.

    ``device`` defaults to CUDA; with no CUDA device the caller must pass
    ``device="cpu"``, which runs the plain PyTorch versions of the kernels
    (the tests' reference path)."""

    def __init__(self, cfg: Config, height: int, width: int, device=None):
        self.device = resolve_device(device, "StereoFrontend")
        self.cfg = cfg
        self.extractor = OrbExtractor(cfg.orb, height, width)
        self.shapes = self.extractor.shapes
        dev = self.device
        self.scale_factors = torch.as_tensor(cfg.orb.scale_factors(),
                                             dtype=torch.float32, device=dev)
        self.level_widths = torch.as_tensor(
            np.array([s[1] for s in self.shapes], np.int32), device=dev)
        self.level_offsets = torch.as_tensor(
            self.extractor.level_offsets.astype(np.int32), device=dev)
        # seeding quality 2/(1 + cost/256) - 1 of each uint8 cost
        self._qual256 = numerics.quality_table(256.0).to(dev)
        self._fcn = None
        self._frame_count = 0

    def attach_introspection(self, net, net_hw=(512, 512)):
        """Run the introspection FCN (models.IntrospectionNet, in eval mode)
        on every submitted left image and weight the extraction with its
        cost map, as the reference hands the TorchScript model's byte map to
        TrackStereo (stereo_kitti.cc:492-517). The network moves to the
        frontend's device; its cost map stays there. A cost map passed to
        submit takes precedence."""
        self._fcn = (net.to(self.device), tuple(int(v) for v in net_hw))

    def _cost_map(self, cost_map, pair: torch.Tensor):
        """The frame's (H, W) uint8 cost map on the device: the caller's,
        else the attached FCN's on the grayscale left image stacked to RGB,
        else None."""
        if cost_map is not None:
            cost = torch.as_tensor(cost_map)
            if cost.dtype != torch.uint8 or tuple(cost.shape) != tuple(pair.shape[1:]):
                raise ValueError(f"cost_map: need an {tuple(pair.shape[1:])} uint8 map, got "
                                 f"{tuple(cost.shape)} {cost.dtype}")
            if cost.device != self.device:
                if self.device.type == "cuda":
                    cost = cost.pin_memory()
                cost = cost.to(self.device, non_blocking=True)
            return cost.contiguous()
        if self._fcn is not None:
            net, net_hw = self._fcn
            rgb = pair[0][..., None].expand(-1, -1, 3)
            return inference_cost_map(net, rgb, tuple(pair.shape[1:]), net_hw)
        return None

    def _step(self, pair: torch.Tensor, cost: Optional[torch.Tensor]) -> FrameHandle:
        """(2, H, W) uint8 device pair (+ the left image's (H, W) uint8 cost
        map, or None) -> queued frame work."""
        cam = self.cfg.camera
        # left/right as ONE batch axis (the reference's two extraction
        # threads, Frame.cc:116-124); the right image gets a zero cost map,
        # the exact unweighted semantics
        levels = pyr.build_pyramid(pair, self.shapes)
        qlevels = None
        if cost is not None:
            qlevels = pyr.build_pyramid(torch.stack([cost, torch.zeros_like(cost)]),
                                        self.shapes)
        kb, canvas = self.extractor.extract_from_pyramid_batched(
            levels, qlevels, return_canvas=True)
        kl = Keypoints(*(a[0] for a in kb))
        kr = Keypoints(*(a[1] for a in kb))
        u_right, depth = stereo.match_stereo(
            kl.xy, kl.octave, kl.desc, kl.valid,
            kr.xy, kr.octave, kr.desc, kr.valid,
            canvas[0], canvas[1], self.level_offsets, self.level_widths,
            self.scale_factors, cam.bf, cam.baseline,
        )
        if cost is not None:
            # seed per-keypoint quality from the cost map at the keypoint
            # pixel: 2/(1 + cost/256) - 1 (Frame.cc:130-143; /256 here, /255
            # in the extractor's weighting, as in the reference)
            xs = torch.clamp(torch.round(kl.xy[:, 0]).to(torch.int64), 0, cam.width - 1)
            ys = torch.clamp(torch.round(kl.xy[:, 1]).to(torch.int64), 0, cam.height - 1)
            qual = self._qual256[cost[ys, xs].to(torch.int64)]
        else:
            qual = torch.ones(kl.xy.shape[0], dtype=torch.float32, device=pair.device)
        # all host-bound per-frame fields as ONE tensor, so collect() is one
        # download; int/bool columns are exact in float32 (values << 2^24)
        host_pack = torch.stack(
            [kl.xy[:, 0], kl.xy[:, 1], kl.octave.to(torch.float32),
             kl.valid.to(torch.float32), u_right, depth, qual], dim=1)
        return FrameHandle(kl, kr, u_right, depth, qual, host_pack)

    def submit(self, img_left: np.ndarray, img_right: np.ndarray,
               cost_map=None) -> FrameHandle:
        """Queue the device work for one frame and return at once. The pair
        (and the left image's (H, W) uint8 cost map, when given: a numpy
        array or a tensor) is uploaded from pinned memory without a stream
        sync, so frame n+1 can be submitted while frame n computes."""
        pair = torch.from_numpy(np.ascontiguousarray(np.stack([img_left, img_right])))
        if self.device.type == "cuda":
            pair = pair.pin_memory().to(self.device, non_blocking=True)
        return self.submit_device(pair, cost_map)

    def submit_device(self, pair: torch.Tensor, cost_map=None) -> FrameHandle:
        """submit() for a (2, H, W) uint8 stereo pair already on the device
        (the staged-replay path)."""
        if pair.device != self.device or pair.dtype != torch.uint8 or pair.ndim != 3:
            raise ValueError(
                f"submit_device: need a (2, H, W) uint8 tensor on {self.device}, "
                f"got {tuple(pair.shape)} {pair.dtype} on {pair.device}")
        pair = pair.contiguous()
        return self._step(pair, self._cost_map(cost_map, pair))

    def prefetch_host(self, handle: FrameHandle) -> None:
        """Queue the device->host copy of the handle's host pack into pinned
        memory right behind the frame's work, so collect() finds it done.
        Safe to call more than once; a no-op on the CPU."""
        if handle.host_copy is not None or handle.host_pack.device.type != "cuda":
            return
        handle.host_copy = handle.host_pack.to("cpu", non_blocking=True)
        handle.copied = torch.cuda.Event()
        handle.copied.record(torch.cuda.current_stream(handle.host_pack.device))

    def collect(
        self,
        handle: FrameHandle,
        timestamp: float,
        gt_pose: Optional[np.ndarray] = None,
        gt_cov: Optional[np.ndarray] = None,
        img_name: str = "",
        defer: bool = False,
    ) -> Frame:
        """Wait for one frame's host pack (one download) and build its
        Frame; descriptors and angles stay on the device."""
        fid = self._frame_count
        self._frame_count += 1
        fr = Frame(
            frame_id=fid,
            timestamp=timestamp,
            kp=handle.kl,
            u_right=handle.u_right,
            depth=handle.depth,
            qual_score=handle.qual,
            gt_pose=gt_pose,
            gt_cov=gt_cov,
            img_name=img_name,
            defer=True,
            host_pack=handle.host_pack,
            ur_dev=handle.u_right,
            depth_dev=handle.depth,
            qual_dev=handle.qual,
        )
        if not defer:
            if handle.host_copy is not None:
                handle.copied.synchronize()
                pack = handle.host_copy.numpy()
            else:
                pack = handle.host_pack.cpu().numpy()
            _unpack_host(fr, pack)
            fr.defer = False
            fr.host_pack = None
        return fr

    def process(
        self,
        img_left: np.ndarray,
        img_right: np.ndarray,
        timestamp: float,
        cost_map=None,
        gt_pose: Optional[np.ndarray] = None,
        gt_cov: Optional[np.ndarray] = None,
        img_name: str = "",
        defer: bool = False,
    ) -> Frame:
        """Synchronous submit + collect (the per-frame tracking path)."""
        handle = self.submit(img_left, img_right, cost_map)
        return self.collect(handle, timestamp, gt_pose, gt_cov, img_name,
                            defer=defer)
