"""Port parity: training-data generation (introspection/datagen.py) on a
map recorded from the JAX package's System, and the port's System in the
datagen mode end to end.

The JAX System (no-FMA subprocess, tests/torch_parity.py::_task_datagen)
tracks tests/test_introspection_helps.py's world, a ReflectionWorld (seed
5, 320x240) on its serpentine path (0.1 m a frame, yaw amplitude 0.3: a
static band has zero epipolar error under pure translation), with GT poses
and GT depth maps. At frame 6 its map is saved just before
DataGenerator.process_frame_supervised, with that frame, the previous one
and every keyframe's GT depths; that call runs in each of the seven
implemented training modes, and process_frame_unsupervised on the frame's
pose-LM chi2 record. The port loads the map into its MapStore and makes the
same calls on the CPU path:

* per mode: whether a result comes, the scored keypoints (``keep``), the
  count, the bad share and the good-for-training verdict exact; the errors
  within 1e-4 relative + 1e-4 px (float32 algebra in another order); the
  uint8 heatmap within 1 (the GP's float32 Cholesky rounds otherwise);
* unsupervised: the quality labels exact (host numpy), the heatmap within
  1, the variance mask equal on more than 99.9% of its pixels (a pixel
  whose upsampled variance sits at the 0.5 threshold may flip).

Then the port's System alone (10 frames of the same world, GT poses
relative to the first camera as KITTI's): the supervised mode writes the reference's dataset layout, and
the unsupervised mode with ``ba_mode="constrained"`` (a keyframe forced
every other frame so that the constrained BA runs) writes heatmaps and
masks and its keypoint quality labels.
"""

import json
import os

import imageio.v3 as iio
import numpy as np
import pytest
import torch

import synth_world
from iv_slam_tpu_torch.introspection.datagen import DataGenerator
from iv_slam_tpu_torch.ops.extractor import Keypoints
from iv_slam_tpu_torch.slam.frame import Frame
from iv_slam_tpu_torch.slam.map_store import MapStore
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import State
from test_torch_fused_track import port_config
from torch_parity import SUPERVISED_MODES, force_keyframe, one_thread, run_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CAM = (400.0, 400.0, 160.0, 120.0, 200.0, 320, 240)
N_FRAMES, RECORD = 8, 6


def serpentine(n, step=0.1, yaw_amp=0.3, seed=5):
    """tests/test_introspection_helps.py::_make_frames on its ReflectionWorld:
    (left, right, depth) per frame and the Twc ground truth."""
    world = synth_world.ReflectionWorld(np.random.default_rng(seed))
    out, gt = [], []
    for i in range(n):
        t = np.array([i * step, 0.03 * np.sin(i * 0.4), 0.0], np.float32)
        Twc = synth_world.camera_pose(t, height=10.0, yaw=yaw_amp * np.sin(i * 0.3))
        out.append(world.render_stereo(Twc) + (world.render_depth(Twc),))
        gt.append(Twc)
    return out, np.stack(gt)


def make_config():
    cfg = port_config(CAM, 600, 4)
    cfg.camera.th_depth = 35.0
    cfg.iv.enabled = True
    cfg.gp.max_train_points = 256
    return cfg


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    frames, gt = serpentine(N_FRAMES)
    d = tmp_path_factory.mktemp("datagen")
    ref = run_reference("datagen", d, timeout=600.0,
                        imgs_l=np.stack([f[0] for f in frames]),
                        imgs_r=np.stack([f[1] for f in frames]),
                        depths=np.stack([f[2] for f in frames]), gt=gt, cam=np.array(CAM),
                        n_features=600, n_levels=4, max_train_points=256,
                        record_frame=RECORD, map_path=str(d / "map.npz"))
    m = MapStore.load(str(d / "map.npz"), n_levels=4, scale_factor=1.2)
    for k in range(m.n_keyframes):
        m.kf_gt_pose[k] = ref["kf_gt_pose"][k]
        m.kf_frames[k].kp_gt_depth = ref["kf_gt_depth"][k]
    return ref, m


def frame_from(ref, pre):
    a = lambda f: ref[pre + f]  # noqa: E731
    n = len(a("xy"))
    kp = Keypoints(xy=torch.from_numpy(a("xy")), response=torch.zeros(n),
                   octave=torch.from_numpy(a("octave")), angle=torch.from_numpy(a("angle")),
                   desc=torch.from_numpy(a("desc")), valid=torch.from_numpy(a("valid")),
                   yx_level=torch.zeros((n, 2), dtype=torch.int32))
    return Frame(frame_id=int(a("frame_id")), timestamp=0.0, kp=kp, u_right=a("u_right").copy(),
                 depth=a("depth").copy(), qual_score=np.ones(n, np.float32),
                 pose=a("pose").copy(), map_pt=a("map_pt").copy(), gt_pose=a("gt_pose"),
                 kp_gt_depth=a("gt_depth").copy(), img_name=str(a("img_name")))


@pytest.mark.parametrize("mode", SUPERVISED_MODES)
def test_process_frame_supervised_matches_jax(recorded, mode):
    ref, m = recorded
    cfg = make_config()
    cfg.iv.training_mode = mode
    dg = DataGenerator(cfg, m, None, device="cpu")
    cur, prev = frame_from(ref, "cur_"), frame_from(ref, "prev_")
    assert int(cur.frame_id) == RECORD and (cur.kp_gt_depth > 0).sum() > 100
    r = dg.process_frame_supervised(cur, (240, 320), prev_frame=prev)
    assert (r is None) == bool(ref[mode + "_none"]) is False
    np.testing.assert_array_equal(r["keep"], ref[mode + "_keep"])
    assert r["n_scored"] == int(ref[mode + "_n_scored"]) > 50
    assert r["bad_percent"] == float(ref[mode + "_bad_percent"])
    assert r["good"] == bool(ref[mode + "_good"])
    np.testing.assert_allclose(r["norm_err"], ref[mode + "_norm_err"], rtol=1e-4, atol=1e-4)
    hm = r["heatmap"]
    assert hm.dtype == np.uint8 and hm.shape == ref[mode + "_heatmap"].shape == (240, 320)
    assert np.abs(hm.astype(int) - ref[mode + "_heatmap"].astype(int)).max() <= 1


def test_process_frame_unsupervised_matches_jax(recorded):
    ref, m = recorded
    dg = DataGenerator(make_config(), m, None, device="cpu")
    cur = frame_from(ref, "cur_")
    r = dg.process_frame_unsupervised(cur, ref["unsup_chi2"], ref["unsup_dof"],
                                      ref["unsup_found"], True, (240, 320))
    np.testing.assert_array_equal(r["qual"], ref["unsup_qual"])
    assert np.abs(r["heatmap"].astype(int) - ref["unsup_heatmap"].astype(int)).max() <= 1
    assert (r["mask"] == ref["unsup_mask"]).mean() > 0.999
    assert 0 < (r["mask"] == 255).mean() < 1
    assert r["good"] == bool(ref["unsup_good"])


@pytest.fixture(scope="module")
def frames():
    """Ten frames with their GT poses relative to the first camera, as
    KITTI's are: the constrained BA pins keyframes to these poses in the
    map's frame, which the first keyframe anchors at the identity."""
    seq, gt = serpentine(10)
    return seq, np.linalg.inv(gt[0])[None] @ gt


def test_supervised_datagen_end_to_end(frames, tmp_path):
    """tests/test_datagen.py::test_supervised_datagen_end_to_end on the port:
    the dataset layout the reference's trainer reads."""
    (seq, gt) = frames
    s = System(make_config(), 240, 320, device="cpu")
    out = str(tmp_path / "generated_training_data")
    s.enable_datagen(out)
    for i, (left, right, depth) in enumerate(seq):
        s.track_stereo(left, right, timestamp=i * 0.1, gt_pose=gt[i], img_name=f"{i:06d}.png",
                       gt_depth_map=depth)
    assert s.state == State.OK
    dg = s.tracking.datagen
    dg.finalize()
    assert dg.n_saved >= 1
    names = os.listdir(os.path.join(out, "bad_region_heatmap"))
    assert len(names) == dg.n_saved
    hm = iio.imread(os.path.join(out, "bad_region_heatmap", names[0]))
    assert hm.dtype == np.uint8 and hm.shape == (240, 320)
    kp = json.load(open(os.path.join(out, "keypoints.json")))
    im = json.load(open(os.path.join(out, "img_names.json")))
    assert len(im["img_name"]) == dg.n_saved and len(kp["x_coord"]) > 10 * dg.n_saved
    rows = open(os.path.join(out, "descriptors.csv")).read().splitlines()
    assert len(rows) == len(kp["x_coord"]) and len(rows[0].split(",")) == 32


def test_unsupervised_constrained_datagen_end_to_end(frames, tmp_path):
    (seq, gt) = frames
    cfg = make_config()
    cfg.iv.unsupervised_learning = True
    cfg.iv.ba_mode = "constrained"
    s = System(cfg, 240, 320, device="cpu")
    out = str(tmp_path / "unsup")
    s.enable_datagen(out)
    tr = s.tracking
    for i, (left, right, _d) in enumerate(seq):
        s.track_stereo(left, right, timestamp=i * 0.1, gt_pose=gt[i], img_name=f"{i:06d}.png")
        force_keyframe(tr, i, 2)
    assert s.state == State.OK and s.failure_count == 0
    tr.datagen.finalize()
    m = tr.map
    assert m.n_keyframes >= 4
    # the constrained BA pinned the window's keyframes to ground truth and
    # labelled their keypoints
    k = m.n_keyframes - 2
    np.testing.assert_allclose(m.kf_pose[k], np.linalg.inv(m.kf_gt_pose[k]), atol=1e-6)
    labelled = [(m.kf_frames[k].qual_score != 1.0).sum() for k in range(m.n_keyframes)]
    assert sum(labelled) > 100, labelled
    assert tr.datagen.n_saved >= 1
    for sub in ("bad_region_heatmap", "bad_region_heatmap_mask"):
        assert len(os.listdir(os.path.join(out, sub))) == tr.datagen.n_saved
