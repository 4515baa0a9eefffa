"""Per-frame data bundle + the frontends that fill it.

Port of ``iv_slam_tpu/slam/frame.py``: ``StereoFrontend``, the reference's
Frame stereo constructor (Frame.cc:89-230) — ORB
extraction on both images, weighted by an introspection cost map when one
is given or an FCN is attached, stereo matching, quality-score seeding.
Both images go through the extractor as one batch; the whole frame,
the FCN included, is queued on the device's current stream with no host
synchronisation, so ``submit`` returns at once and ``collect`` waits for
one (N, 7) download. ``MonoFrontend`` (the mono constructor,
Frame.cc:308-413) and ``RGBDFrontend`` (the RGB-D one, Frame.cc:232-305)
extract one image; each frame is one download, and the RGB-D depth
sampled on the host at the keypoints goes up once. ``sample_gt_depth``
gives the per-keypoint ground-truth depth of the feature evaluator.

Host-side state (pose, map-point associations, outlier flags) lives in
NumPy; the padded keypoint tensors, and each frame's u_right, depth and
quality, stay on the device for the downstream matchers and optimizers.
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
from ..utils.profiling import span
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
    # the pose LM's final chi2 per keypoint and its degrees of freedom (3
    # stereo, 2 mono, 0 unmatched), for unsupervised introspection
    chi2: Optional[np.ndarray] = None
    chi2_dof: Optional[np.ndarray] = None
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
    # StereoFrontend's count of the frame at submit: the id of its spans
    frame_no: Optional[int] = None
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


def sample_gt_depth(
    depth_map: np.ndarray, xy: np.ndarray, valid: np.ndarray,
    patch: int = 5, max_depth: float = 600.0,
) -> np.ndarray:
    """Per-keypoint ground-truth depth as the minimum over a 5x5 patch
    around the keypoint (Frame.cc:152-191 mvKeysGTDepth; sky masked at
    600 m). Returns (N,) float32; -1 where invalid."""
    half = patch // 2
    out = np.full(len(xy), -1.0, np.float32)
    for i in np.nonzero(valid)[0]:
        px = int(round(float(xy[i, 0])))
        py = int(round(float(xy[i, 1])))
        x0, y0 = max(px - half, 0), max(py - half, 0)
        p = depth_map[y0:y0 + patch, x0:x0 + patch]
        if p.size:
            d = float(p.min())
            if d < max_depth:
                out[i] = d
    return out


def _to_device(a, shape, dtype, device, name: str) -> torch.Tensor:
    """An (H, W) map (numpy array or tensor) of the given dtype on `device`,
    uploaded from pinned memory without a stream sync."""
    t = torch.as_tensor(a)
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a {tuple(shape)} {dtype} map, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        if device.type == "cuda":
            t = t.contiguous().pin_memory()
        t = t.to(device, non_blocking=True)
    return t.contiguous()


def _host_frame(fid, timestamp, kp, ur, depth, qual, **kw) -> Frame:
    """A materialized Frame of one image's keypoints and the device tensors
    u_right/depth/qual (N,), with one download for the host views."""
    pack = torch.stack([kp.xy[:, 0], kp.xy[:, 1], kp.octave.to(torch.float32),
                        kp.valid.to(torch.float32), ur, depth, qual], dim=1)
    fr = Frame(frame_id=fid, timestamp=timestamp, kp=kp, u_right=ur, depth=depth,
               qual_score=qual, defer=True, ur_dev=ur, depth_dev=depth, qual_dev=qual, **kw)
    _unpack_host(fr, pack.cpu().numpy())
    fr.defer = False
    return fr


class MonoFrontend:
    """Monocular frontend (Frame.cc:308-413 mono ctor): extraction,
    weighted by a cost map when one is given; stereo fields stay at -1."""

    def __init__(self, cfg: Config, height: int, width: int, device=None):
        self.device = resolve_device(device, "MonoFrontend")
        self.cfg = cfg
        self.extractor = OrbExtractor(cfg.orb, height, width)
        self._qual256 = numerics.quality_table(256.0).to(self.device)
        self._frame_count = 0

    def process(
        self,
        img: np.ndarray,
        timestamp: float,
        cost_map: Optional[np.ndarray] = None,
        gt_pose: Optional[np.ndarray] = None,
        img_name: str = "",
    ) -> Frame:
        dev = self.device
        shape = (self.extractor.height, self.extractor.width)
        img_t = _to_device(img, shape, torch.uint8, dev, "img")
        cost = (_to_device(cost_map, shape, torch.uint8, dev, "cost_map")
                if cost_map is not None else None)
        kp = self.extractor(img_t, cost)
        n = kp.xy.shape[0]
        if cost is not None:
            # 2/(1 + cost/256) - 1 at the keypoint pixel (Frame.cc:130-143)
            xs = torch.clamp(torch.round(kp.xy[:, 0]).to(torch.int64), 0, shape[1] - 1)
            ys = torch.clamp(torch.round(kp.xy[:, 1]).to(torch.int64), 0, shape[0] - 1)
            qual = self._qual256[cost[ys, xs].to(torch.int64)]
        else:
            qual = torch.ones(n, dtype=torch.float32, device=dev)
        fid = self._frame_count
        self._frame_count += 1
        none = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
        return _host_frame(fid, timestamp, kp, none, none.clone(), qual,
                           gt_pose=gt_pose, img_name=img_name)


class RGBDFrontend:
    """RGB-D frontend (Frame.cc:232-305 RGBD ctor): depth sampled at
    the keypoint pixels on the host, virtual right coordinate
    u_r = u - bf / depth, both uploaded once for the device matchers."""

    def __init__(self, cfg: Config, height: int, width: int, device=None):
        self.device = resolve_device(device, "RGBDFrontend")
        self.cfg = cfg
        self.extractor = OrbExtractor(cfg.orb, height, width)
        self._frame_count = 0

    def process(
        self,
        img: np.ndarray,
        depth_map: np.ndarray,
        timestamp: float,
        depth_scale: float = 1.0,
        img_name: str = "",
    ) -> Frame:
        """depth_map: (H, W) depth in any numeric type; depth_scale turns it
        into metres (1 / DepthMapFactor for a TUM uint16 map)."""
        dev = self.device
        shape = (self.extractor.height, self.extractor.width)
        kp = self.extractor(_to_device(img, shape, torch.uint8, dev, "img"))
        n = kp.xy.shape[0]
        xy = kp.xy.cpu().numpy()
        xs = np.clip(np.rint(xy[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
        ys = np.clip(np.rint(xy[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
        depth = depth_map[ys, xs].astype(np.float32) * depth_scale
        valid_d = depth > 0
        u_right = np.where(
            valid_d, xy[:, 0] - self.cfg.camera.bf / np.maximum(depth, 1e-6), -1.0,
        ).astype(np.float32)
        depth = np.where(valid_d, depth, -1.0).astype(np.float32)
        fid = self._frame_count
        self._frame_count += 1
        up = lambda a: _to_device(a, (n,), torch.float32, dev, "depth")  # noqa: E731
        return _host_frame(fid, timestamp, kp, up(u_right), up(depth),
                           torch.ones(n, dtype=torch.float32, device=dev), img_name=img_name)


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
    # the frontend's count of the frame at submit: the id of its spans
    frame_no: Optional[int] = None


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
        self.next_frame_no = 0   # the frame_no the next submit takes

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
            return _to_device(cost_map, pair.shape[1:], torch.uint8, self.device, "cost_map")
        if self._fcn is not None:
            net, net_hw = self._fcn
            rgb = pair[0][..., None].expand(-1, -1, 3)
            return inference_cost_map(net, rgb, tuple(pair.shape[1:]), net_hw)
        return None

    def _step(self, pair: torch.Tensor, cost: Optional[torch.Tensor],
              frame_no: Optional[int] = None) -> FrameHandle:
        """(2, H, W) uint8 device pair (+ the left image's (H, W) uint8 cost
        map, or None) -> queued frame work."""
        cam = self.cfg.camera
        # left/right as ONE batch axis (the reference's two extraction
        # threads, Frame.cc:116-124); the right image gets a zero cost map,
        # the exact unweighted semantics
        with span("frontend.extract", frame=frame_no):
            levels = pyr.build_pyramid(pair, self.shapes)
            qlevels = None
            if cost is not None:
                qlevels = pyr.build_pyramid(torch.stack([cost, torch.zeros_like(cost)]),
                                            self.shapes)
            kb, canvas = self.extractor.extract_from_pyramid_batched(
                levels, qlevels, return_canvas=True)
        kl = Keypoints(*(a[0] for a in kb))
        kr = Keypoints(*(a[1] for a in kb))
        with span("frontend.stereo", frame=frame_no):
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
        return FrameHandle(kl, kr, u_right, depth, qual, host_pack, frame_no=frame_no)

    def submit(self, img_left: np.ndarray, img_right: np.ndarray,
               cost_map=None) -> FrameHandle:
        """Queue the device work for one frame and return at once. The pair
        (and the left image's (H, W) uint8 cost map, when given: a numpy
        array or a tensor) is uploaded from pinned memory without a stream
        sync, so frame n+1 can be submitted while frame n computes."""
        with span("frontend.upload", frame=self.next_frame_no):
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
        frame_no = self.next_frame_no
        self.next_frame_no += 1
        pair = pair.contiguous()
        return self._step(pair, self._cost_map(cost_map, pair), frame_no)

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
            frame_no=handle.frame_no,
        )
        if not defer:
            with span("frontend.collect", frame=handle.frame_no):
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
