"""Port parity: geometry/se3.py, camera.py and sim3.py against the JAX
package, on tests/test_geometry.py's inputs (and the Sim3 inputs of
tests/test_sim3_and_solvers.py), plus test_geometry.py's own property
checks run on the port with its tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from iv_slam_tpu.geometry import camera as jcam
from iv_slam_tpu.geometry import se3 as jse3
from iv_slam_tpu.geometry import sim3 as jsim3
from iv_slam_tpu_torch.geometry import camera as tcam
from iv_slam_tpu_torch.geometry import se3 as tse3
from iv_slam_tpu_torch.geometry import sim3 as tsim3
from test_geometry import random_se3


def T_(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


def _intrinsics(vals):
    return (jcam.Intrinsics(*(jnp.float32(v) for v in vals)),
            tcam.Intrinsics(*(torch.tensor(v, dtype=torch.float32) for v in vals)))


def _rotvecs(rng):
    w = (rng.normal(size=(32, 3)) * 1.5).astype(np.float32)
    # the Taylor branches: theta^2 below 1e-4, and exactly zero
    w[:4] *= np.float32(1e-3)
    w[4] = 0.0
    return w


def test_so3_exp_log_match_jax(rng):
    w = _rotvecs(rng)
    R = tse3.so3_exp(T_(w))
    close(R, jse3.so3_exp(jnp.asarray(w)), 2e-6)
    np.testing.assert_allclose(R.numpy()[5:], Rotation.from_rotvec(w[5:]).as_matrix(),
                               atol=1e-5)
    wc = np.clip(w, -1.5, 1.5)
    Rc = jse3.so3_exp(jnp.asarray(wc))
    close(tse3.so3_log(T_(np.asarray(Rc))), jse3.so3_log(Rc), 2e-6)
    np.testing.assert_allclose(tse3.so3_log(tse3.so3_exp(T_(wc))).numpy(), wc, atol=1e-4)
    # hat
    close(tse3.hat(T_(w)), jse3.hat(jnp.asarray(w)), 0)


def test_so3_small_angle():
    w = torch.tensor([[1e-9, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float32)
    R = tse3.so3_exp(w)
    np.testing.assert_allclose(R[1].numpy(), np.eye(3), atol=1e-6)
    assert torch.isfinite(tse3.so3_log(R)).all()


@pytest.mark.parametrize("large", [False, True], ids=["principal", "beyond-pi"])
def test_se3_exp_log_inverse_match_jax(rng, large):
    if large:
        xi = np.concatenate([rng.normal(size=(16, 3)) * 2.0,
                             rng.normal(size=(16, 3)) * 2.0], axis=1).astype(np.float32)
    else:
        xi = random_se3(rng)
        xi[:3, :3] *= np.float32(1e-3)  # Taylor branch
    Tj = jse3.se3_exp(jnp.asarray(xi))
    Tt = tse3.se3_exp(T_(xi))
    close(Tt, Tj, 2e-5)
    Tn = np.asarray(Tj)
    close(tse3.se3_log(T_(Tn)), jse3.se3_log(Tj), 2e-4)
    close(tse3.inverse(T_(Tn)), jse3.inverse(Tj), 2e-5)
    # test_geometry.py's properties on the port
    if large:
        np.testing.assert_allclose(tse3.se3_exp(tse3.se3_log(Tt)).numpy(), Tt.numpy(),
                                   atol=2e-3)
    else:
        np.testing.assert_allclose(tse3.se3_log(Tt).numpy(), xi, atol=1e-3)
    eye = (Tt @ tse3.inverse(Tt)).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape), atol=1e-5)


def test_rt_to_mat_and_transform_points_match_jax(rng):
    xi = random_se3(rng, 4)
    Tn = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    pts = rng.normal(size=(4, 10, 3)).astype(np.float32)
    close(tse3.rt_to_mat(T_(Tn[:, :3, :3]), T_(Tn[:, :3, 3])),
          jse3.rt_to_mat(jnp.asarray(Tn[:, :3, :3]), jnp.asarray(Tn[:, :3, 3])), 0)
    out = tse3.transform_points(T_(Tn[0]), T_(pts[0]))
    close(out, jse3.transform_points(jnp.asarray(Tn[0]), jnp.asarray(pts[0])), 1e-6)
    np.testing.assert_allclose(out.numpy(), pts[0] @ Tn[0, :3, :3].T + Tn[0, :3, 3],
                               atol=1e-5)
    # batched poses over batched points
    close(tse3.transform_points(T_(Tn), T_(pts)),
          jse3.transform_points(jnp.asarray(Tn), jnp.asarray(pts)), 1e-6)


def test_quaternions_match_jax(rng):
    w = _rotvecs(rng)
    w[5] = [np.pi - 1e-3, 0.0, 0.0]  # pivots 1 + m00 - m11 - m22 win
    w[6] = [0.0, 3.0, 0.1]
    w[7] = [0.1, 0.0, 3.0]
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    q = tse3.rot_to_quat(T_(R))
    close(q, jse3.rot_to_quat(jnp.asarray(R)), 1e-6)
    close(tse3.quat_to_rot(q), jse3.quat_to_rot(jnp.asarray(q.numpy())), 1e-6)
    np.testing.assert_allclose(tse3.quat_to_rot(q).numpy(), R, atol=1e-5)
    q_ref = Rotation.from_matrix(R).as_quat()
    q_ref *= np.where(q_ref[:, 3:4] < 0, -1.0, 1.0)
    np.testing.assert_allclose(q.numpy(), q_ref, atol=1e-5)


def test_camera_matches_jax(rng):
    vals = (718.0, 718.0, 607.0, 185.0, 386.0)
    Kj, Kt = _intrinsics(vals)
    depth = rng.uniform(1.0, 50.0, size=(64,)).astype(np.float32)
    uv = np.stack([rng.uniform(0, 1200, 64), rng.uniform(0, 370, 64)],
                  axis=-1).astype(np.float32)
    pts_t = tcam.backproject(Kt, T_(uv), T_(depth))
    pts_j = jcam.backproject(Kj, jnp.asarray(uv), jnp.asarray(depth))
    close(pts_t, pts_j, 0)
    close(tcam.project(Kt, pts_t), jcam.project(Kj, pts_j), 0)
    obs = tcam.project_stereo(Kt, pts_t)
    close(obs, jcam.project_stereo(Kj, pts_j), 0)
    np.testing.assert_allclose(tcam.project(Kt, pts_t).numpy(), uv, atol=1e-3)
    np.testing.assert_allclose((obs[:, 0] - obs[:, 2]).numpy(), 386.0 / depth, rtol=1e-5)
    disp = rng.uniform(-1, 60, 64).astype(np.float32)
    close(tcam.disparity_to_depth(Kt, T_(disp)),
          jcam.disparity_to_depth(Kj, jnp.asarray(disp)), 0)


def test_projection_jacobians_match_jax(rng):
    vals = (700.0, 710.0, 600.0, 180.0, 380.0)
    Kj, Kt = _intrinsics(vals)
    pts = np.stack([rng.normal(size=8) * 5, rng.normal(size=8) * 5,
                    rng.uniform(2, 40, 8)], axis=-1).astype(np.float32)
    J = tcam.proj_jacobian_stereo(Kt, T_(pts))
    close(J, jcam.proj_jacobian_stereo(Kj, jnp.asarray(pts)), 0)
    close(tcam.proj_jacobian_mono(Kt, T_(pts)), jcam.proj_jacobian_mono(Kj, jnp.asarray(pts)), 0)
    J_auto = jax.vmap(jax.jacfwd(lambda p: jcam.project_stereo(Kj, p)))(jnp.asarray(pts))
    np.testing.assert_allclose(J.numpy(), np.asarray(J_auto), atol=1e-3)


def test_sim3_matches_jax(rng):
    w = (rng.normal(size=(8, 3)) * 0.8).astype(np.float32)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    sig = rng.normal(size=(8, 1)).astype(np.float32) * 0.5
    # the fallbacks: sigma ~ 0, theta ~ 0, and both
    sig[0] = 1e-5
    w[1] *= 1e-4
    sig[2], w[2] = 0.0, 0.0
    xi = np.concatenate([w, v, sig], axis=1)
    Sj = jsim3.sim3_exp(jnp.asarray(xi))
    St = tsim3.sim3_exp(T_(xi))
    for a, b in zip(St, Sj):
        close(a, b, 5e-6)
    close(tsim3._calc_w(T_(w), T_(sig[:, 0])), jsim3._calc_w(jnp.asarray(w), jnp.asarray(sig[:, 0])),
          5e-6)
    Sn = tsim3.Sim3(*(T_(np.asarray(a)) for a in Sj))
    close(tsim3.sim3_log(Sn), jsim3.sim3_log(Sj), 5e-5)
    np.testing.assert_allclose(tsim3.sim3_log(St).numpy(), xi, atol=2e-4)
    # compose / inverse / act / to_se3 on one element
    a = tsim3.Sim3(St.R[3], St.t[3], St.s[3])
    b = tsim3.Sim3(St.R[4], St.t[4], St.s[4])
    ja = jsim3.Sim3(Sj.R[3], Sj.t[3], Sj.s[3])
    jb = jsim3.Sim3(Sj.R[4], Sj.t[4], Sj.s[4])
    for x, y in zip(a.compose(b), ja.compose(jb)):
        close(x, y, 5e-6)
    for x, y in zip(a.inverse(), ja.inverse()):
        close(x, y, 5e-6)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    close(a.act(T_(pts)), ja.act(jnp.asarray(pts)), 1e-5)
    close(a.to_se3(), ja.to_se3(), 5e-6)
    ident = tsim3.Sim3.identity()
    np.testing.assert_allclose(ident.act(T_(pts)).numpy(), pts, atol=0)
    Tt = tse3.se3_exp(T_(random_se3(rng, 1)[0]))
    np.testing.assert_allclose(tsim3.Sim3.from_se3(Tt).to_se3().numpy(), Tt.numpy(), atol=0)


def test_trajectory_io_and_metrics_match_jax(rng, tmp_path):
    from iv_slam_tpu.io import trajectory as jtraj
    from iv_slam_tpu_torch.io import trajectory as ttraj

    xi = random_se3(rng, 12) * np.float32(0.3)
    gt = [np.asarray(T) for T in jse3.se3_exp(jnp.asarray(xi))]
    est = [np.asarray(T) for T in jse3.se3_exp(jnp.asarray(xi + rng.normal(
        0, 0.01, xi.shape).astype(np.float32)))]
    for scale in (False, True):
        assert ttraj.ate_rmse(est, gt, scale) == jtraj.ate_rmse(est, gt, scale)
    for kw in (dict(kind="trans"), dict(kind="rot"), dict(delta=3), dict(delta_m=0.5)):
        assert ttraj.rpe(est, gt, **kw) == jtraj.rpe(est, gt, **kw)
    times = list(np.arange(12) * 0.1)
    for name, (save_j, save_t, args) in {
            "kitti": (jtraj.save_kitti, ttraj.save_kitti, (est,)),
            "tum": (jtraj.save_tum, ttraj.save_tum, (times, est)),
            "times": (jtraj.save_times, ttraj.save_times, (times,))}.items():
        save_j(str(tmp_path / f"j_{name}.txt"), *args)
        save_t(str(tmp_path / f"t_{name}.txt"), *args)
        j, t = (np.loadtxt(tmp_path / f"{w}_{name}.txt") for w in "jt")
        if name == "tum":  # quaternions from rot_to_quat: within its 1e-6
            np.testing.assert_array_equal(t[:, :4], j[:, :4])
            np.testing.assert_allclose(t[:, 4:], j[:, 4:], rtol=0, atol=1e-6)
        else:
            assert (tmp_path / f"j_{name}.txt").read_text() == \
                (tmp_path / f"t_{name}.txt").read_text()
    back = ttraj.load_kitti(str(tmp_path / "t_kitti.txt"))
    np.testing.assert_array_equal(np.stack(back), np.stack(jtraj.load_kitti(
        str(tmp_path / "j_kitti.txt"))))
