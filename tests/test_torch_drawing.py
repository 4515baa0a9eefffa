"""The port's drawing modules against the JAX package's, on the same numpy
inputs: introspection/vis.py, slam/viewer.py, slam/live_viewer.py and
slam/ar.py.

Exact wherever no text is drawn: the heatmap overlays (plain, masked, the
good/bad dot), the epipolar and reprojection error vectors, FrameDrawer's
squares and dots, MapDrawer (points, covisibility graph, keyframes,
trajectory, GT, the follow-camera window), draw_heatmap_overlay, the AR
planes for the same seeds (the same numpy generator) and the AR overlay
(LINE_AA); FeatureEvalVisualizer's heatmap JPEGs are byte-equal to the JAX
package's (the port's encoder writes cv2's bytes).

Text (ROADMAP C6): the JAX package draws it with the installed cv2, which
is OpenCV 5 here and draws FONT_HERSHEY_* from outline fonts, while the
port draws OpenCV 4's Hershey strokes (tests/test_torch_raster.py). Outside
a text's box the two are equal; inside it a pixel may differ only where the
port drew white text or the JAX image is lighter in every channel (white
text blended in).

The live viewer's routes are tests/test_live_viewer.py's, with each streamed
part decoded by the port's decoder to the published image's size and equal
to the port's encoding of it.
"""

import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from iv_slam_tpu.introspection import vis as jvis
from iv_slam_tpu.slam import ar as jar
from iv_slam_tpu.slam import viewer as jviewer
from iv_slam_tpu_torch.introspection import vis as tvis
from iv_slam_tpu_torch.io import jpeg
from iv_slam_tpu_torch.io.png import read_png
from iv_slam_tpu_torch.slam import ar as tar
from iv_slam_tpu_torch.slam import viewer as tviewer
from iv_slam_tpu_torch.slam.live_viewer import LiveViewer
from synth_world import PlaneWorld, camera_pose
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

WHITE = np.array([255, 255, 255])


def _equal_outside_text(got, want, box):
    """Equal outside box = (x0, y0, x1, y1). Inside it, a pixel that differs
    is white text in the port's image (its Hershey strokes) or lighter in
    every channel in the JAX image (cv2 5's outline font blends white
    text in)."""
    x0, y0, x1, y1 = box
    mask = np.zeros(got.shape[:2], bool)
    mask[max(y0, 0):y1, max(x0, 0):x1] = True
    diff = (got != want).any(-1)
    assert not (diff & ~mask).any(), np.argwhere(diff & ~mask)[:5]
    text = (got == WHITE).all(-1) | (want >= got).all(-1)
    assert not (diff & mask & ~text).any(), np.argwhere(diff & mask & ~text)[:5]


@pytest.fixture
def img():
    return np.random.default_rng(5).integers(0, 255, (120, 160), np.uint8)


@pytest.mark.parametrize("good", [True, False, None])
def test_overlay_heatmap(img, good):
    hm = np.random.default_rng(6).integers(0, 256, (120, 160), dtype=np.uint8)
    np.testing.assert_array_equal(tvis.overlay_heatmap_on_image(img, hm, good=good),
                                  jvis.overlay_heatmap_on_image(img, hm, good=good))
    mask = np.random.default_rng(7).integers(0, 2, (120, 160))
    np.testing.assert_array_equal(tvis.overlay_heatmap_on_image(img, hm, mask, good),
                                  jvis.overlay_heatmap_on_image(img, hm, mask, good))


def test_error_vectors(img):
    rng = np.random.default_rng(8)
    kp = rng.uniform(-10, 170, (80, 2))
    feet = kp + rng.normal(0, 8, (80, 2))
    errs = rng.uniform(-1, 3, 80)
    gt = kp + rng.normal(0, 3, (80, 2))
    gt[::5, 0] = -1
    np.testing.assert_array_equal(
        tvis.draw_epipolar_err_vec(img, kp, feet, errs, gt_reproj=gt),
        jvis.draw_epipolar_err_vec(img, kp, feet, errs, gt_reproj=gt))
    _equal_outside_text(tvis.draw_epipolar_err_vec(img, kp, feet, errs, bad_percent=12.5),
                        jvis.draw_epipolar_err_vec(img, kp, feet, errs, bad_percent=12.5),
                        (0, 0, 160, 40))
    np.testing.assert_array_equal(tvis.draw_reprojection_err_vec(img, feet, kp, errs, 1.0),
                                  jvis.draw_reprojection_err_vec(img, feet, kp, errs, 1.0))


def test_visualizer_save_frame(tmp_path, img):
    result = dict(heatmap=np.random.default_rng(9).integers(0, 256, (120, 160), dtype=np.uint8),
                  good=True, bad_percent=7.0, mask=np.ones((120, 160), np.uint8),
                  vis_keypoints=np.array([[30.0, 30.0], [90.0, 60.0]]),
                  vis_feet=np.array([[40.0, 30.0], [80.0, 66.0]]),
                  vis_errs=np.array([1.5, 0.2]), vis_reproj=np.array([[35.0, 30.0], [9.0, 9.0]]),
                  vis_thresh=1.0)
    tvis.FeatureEvalVisualizer(str(tmp_path / "port")).save_frame(img, "000042.png", result)
    jvis.FeatureEvalVisualizer(str(tmp_path / "jax")).save_frame(img, "000042.png", result)
    for d in tvis.FeatureEvalVisualizer.DIRS:
        got = (tmp_path / "port" / d / "000042.jpg").read_bytes()
        assert jpeg.decode(got, "bgr").shape == (120, 160, 3), d
        if d != "epipolar_err_vec":          # the one with text
            assert got == (tmp_path / "jax" / d / "000042.jpg").read_bytes(), d


def _frame(rng, n=400, h=120, w=160):
    return SimpleNamespace(
        frame_id=7, valid=rng.random(n) < 0.8,
        xy=np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)], 1).astype(np.float32),
        map_pt=np.where(rng.random(n) < 0.5, rng.integers(0, 99, n), -1).astype(np.int32),
        qual_score=rng.uniform(-0.2, 1.2, n).astype(np.float32))


def test_frame_drawer(img, tmp_path):
    fr = _frame(np.random.default_rng(10))
    got = tviewer.FrameDrawer(str(tmp_path)).draw(img, fr, "OK")
    want = jviewer.FrameDrawer().draw(img, fr, "OK")
    _equal_outside_text(got, want, (0, 90, 160, 120))
    np.testing.assert_array_equal(read_png(str(tmp_path / "frame_000007.png"))[..., ::-1], got)


def test_heatmap_overlay_drawer(img):
    rng = np.random.default_rng(11)
    hm = rng.integers(0, 256, (110, 150), dtype=np.uint8)
    kp = rng.uniform(0, 150, (50, 2))
    e = rng.uniform(-1, 5, 50)
    for good in (True, False):
        np.testing.assert_array_equal(tviewer.draw_heatmap_overlay(img, hm, good, kp, e),
                                      jviewer.draw_heatmap_overlay(img, hm, good, kp, e))


def _map_store(rng, n=600, k=9):
    pos = np.stack([rng.uniform(-20, 20, n), rng.normal(0, 1, n), rng.uniform(0, 60, n)],
                   1).astype(np.float32)
    centers = np.stack([np.linspace(0, 8, k), np.zeros(k), np.linspace(0, 50, k)],
                       1).astype(np.float32)
    return SimpleNamespace(
        pt_pos=pos, pt_alive=rng.random(n) < 0.9, n_points=n - 20, n_keyframes=k,
        kf_alive=np.arange(k) != 3, kf_camera_center=lambda i: centers[i],
        covisible_keyframes=lambda i: [(j, 150 - 20 * abs(j - i)) for j in range(k) if j != i],
        pt_obs=[{j: 0 for j in range(int(c))} for c in rng.integers(0, 9, n)])


@pytest.mark.parametrize("follow", [False, True])
def test_map_drawer(follow):
    rng = np.random.default_rng(12)
    m = _map_store(rng)
    traj = [np.eye(4) for _ in range(30)]
    for i, T in enumerate(traj):
        T[:3, 3] = (0.3 * i, 0.0, 1.7 * i)
    gt = [T.copy() for T in traj]
    for T in gt:
        T[0, 3] += 0.5
    kw = dict(gt_twc=gt, show_graph=True, follow_camera=follow, follow_extent=25.0)
    np.testing.assert_array_equal(tviewer.MapDrawer().draw(m, traj, **kw),
                                  jviewer.MapDrawer().draw(m, traj, **kw))


def _read_one_jpeg(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
        assert r.readline().strip() == b"--ivframe"
        headers = {}
        while True:
            line = r.readline().strip()
            if not line:
                break
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        return r.read(int(headers["content-length"]))


def test_live_viewer_streams():
    viewer = LiveViewer(port=0).start()
    try:
        frame = np.zeros((48, 64, 3), np.uint8)
        frame[10:20, 10:30] = (0, 255, 0)
        map_img = np.full((64, 64, 3), 40, np.uint8)
        viewer.publish(frame, map_img, stats=dict(frame_id=7, state="OK", n_points=123))
        base = f"http://127.0.0.1:{viewer.port}"
        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"frame.mjpg" in page and b"map.mjpg" in page
        stats = json.loads(urllib.request.urlopen(base + "/stats.json", timeout=5).read())
        assert stats == {"frame_id": 7, "state": "OK", "n_points": 123}
        for path, im in (("/frame.mjpg", frame), ("/map.mjpg", map_img)):
            data = _read_one_jpeg(base + path)
            assert data == jpeg.encode(im, 80)
            assert jpeg.decode(data, "bgr").shape == im.shape
        viewer.publish(frame // 2, None, stats=dict(frame_id=8))
        assert json.loads(urllib.request.urlopen(base + "/stats.json",
                                                 timeout=5).read())["frame_id"] == 8
    finally:
        viewer.stop()


def _post(url, payload, timeout=5.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_live_viewer_control_channel():
    calls = []
    viewer = (LiveViewer(port=0)
              .register_control("localization_mode", lambda v: calls.append(("loc", v)))
              .register_control("reset", lambda v: calls.append(("reset", v))).start())
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        ctl = json.loads(urllib.request.urlopen(base + "/controls.json", timeout=5).read())
        assert ctl["options"]["show_points"] is True
        assert set(ctl["actions"]) == {"localization_mode", "reset"}
        assert b"/control" in urllib.request.urlopen(base + "/", timeout=5).read()
        status, body = _post(base + "/control", {"action": "show_points", "value": False})
        assert status == 200 and body["ok"] and viewer.options["show_points"] is False
        assert _post(base + "/control", {"action": "localization_mode", "value": True})[0] == 200
        assert _post(base + "/control", {"action": "reset"})[0] == 200
        assert calls == [("loc", True), ("reset", True)]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/control", {"action": "warp_drive"})
        assert e.value.code == 422
    finally:
        viewer.stop()


@pytest.mark.parametrize("seed", range(4))
def test_ar_plane_and_overlay(seed):
    rng = np.random.default_rng(100 + seed)
    n_in, n_out = 300, 60
    pts = np.concatenate([
        np.stack([rng.uniform(-5, 5, n_in), rng.uniform(-5, 5, n_in),
                  rng.normal(0, 0.01, n_in)], 1),
        np.stack([rng.uniform(-5, 5, n_out), rng.uniform(-5, 5, n_out),
                  rng.uniform(0.5, 3.0, n_out)], 1)])
    Twc = camera_pose((0.1 * seed, 0), height=10.0)
    Tcw = np.linalg.inv(Twc).astype(np.float32)
    pj = jar.detect_plane(pts, np.full(len(pts), 6), Tcw, rng=np.random.default_rng(seed))
    pt = tar.detect_plane(pts, np.full(len(pts), 6), Tcw, rng=np.random.default_rng(seed))
    for f in ("origin", "R", "inliers"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    world = PlaneWorld(np.random.default_rng(2))
    img = world.render(Twc)
    np.testing.assert_array_equal(tar.draw_ar_overlay(img, Tcw, world.K, pt, 1.0 + seed),
                                  jar.draw_ar_overlay(img, Tcw, world.K, pj, 1.0 + seed))


def test_ar_renderer_on_a_map():
    """ARRenderer's detection gate and relaxation over frames on a map whose
    points lie on the ground, the same in both packages."""
    rng = np.random.default_rng(13)
    m = _map_store(rng, n=300)
    m.pt_pos[:, 1] = rng.normal(0, 0.01, len(m.pt_pos))
    world = PlaneWorld(np.random.default_rng(2))
    K = world.K
    rj, rt = jar.ARRenderer(K, patience=2, seed=4), tar.ARRenderer(K, patience=2, seed=4)
    Twc = camera_pose((0, 0), height=10.0)
    img = world.render(Twc)
    Tcw = np.linalg.inv(Twc).astype(np.float32)
    for _ in range(4):
        np.testing.assert_array_equal(rt.render(img, Tcw, m), rj.render(img, Tcw, m))
        assert (rt.plane is None) == (rj.plane is None) and rt.min_obs == rj.min_obs
    assert rt.plane is not None
