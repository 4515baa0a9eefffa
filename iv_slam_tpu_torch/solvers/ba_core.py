"""Bundle-adjustment core: Levenberg-Marquardt with a Schur-complement
reduction.

Port of ``iv_slam_tpu/solvers/ba_core.py`` (g2o's BlockSolver_6_3 +
OptimizationAlgorithmLevenberg as Optimizer::LocalBundleAdjustment uses
them, Optimizer.cc:505-871):

  * all observations are one padded edge array (E,) with per-edge keyframe
    and point slots;
  * each iteration builds the per-camera blocks (H_cc, g_c) with one-hot
    matrix products, the per-point blocks (H_pp, g_p) and the (6, 3)
    coupling blocks of a dense (P, 6K, 3) tensor U;
  * the reduced system S = H_cc - U^T H_pp^-1 U is one (6K, 3P)x(3P, 6K)
    product and a dense (6K, 6K) solve; the points back-substitute through
    closed-form 3x3 inverses.

Levenberg semantics follow g2o: additive lambda on every diagonal, tau =
1e-5 * max diag, accept on rho > 0 with the 1/3..2/3 scaling, reject with
lambda *= ni, at most MAX_TRIALS trials an iteration. Powell's predicted
decrease uses the ORIGINAL gradient of every block (g2o computeScale), not
the Schur-reduced one (the reference's fix, PARITY.md:110-114).

Repeatable on the GPU: nothing here uses atomics. The reference's segment
sums over points become gathers of a (P, D) table of each point's edges
(sorted once per problem) summed as a fixed float32 tree; U is written by
an index store, its (point, keyframe) pairs being distinct. The products
with the edge and point axes as inner dimension, the reduced solve and the
cost sums run in float64 and are rounded once, so the CPU and the GPU
agree closely. The trial loop is a host loop that reads one flag and rho
per trial (a keyframe event may wait for the device).

``ba_solve`` is the composition of three cut points, the reference's
segmented solver: ``ba_segment`` (LM iterations that carry lambda, the
lambda multiplier ni and the cost chi from one call to the next; ``init``
seeds them as the first iteration of a phase does), ``ba_midpoint`` (the
outlier gate between the phases) and ``ba_finalize`` (the final
classification). Split at any iteration, the segments run the
monolithic solve's arithmetic, so the two are bit-equal. The async local
BA (solvers/local_ba.py) steps them on the LocalMapping worker.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import numerics
from ..geometry import camera, se3
from .pose_opt import DELTA_MONO_SQ, DELTA_STEREO_SQ, _huber_rho0, _huber_w

MAX_TRIALS = 10


class BAProblem(NamedTuple):
    """Valid edges name distinct (point, keyframe) pairs."""

    kf_pose: torch.Tensor    # (K, 4, 4) Tcw
    kf_fixed: torch.Tensor   # (K,) bool
    pt_pos: torch.Tensor     # (P, 3)
    pt_valid: torch.Tensor   # (P,) bool
    e_kf: torch.Tensor       # (E,) int32 slot into kf arrays
    e_pt: torch.Tensor       # (E,) int32 slot into pt arrays
    e_obs: torch.Tensor      # (E, 3) [u, v, ur]; ur < 0 => mono
    e_inv_s2: torch.Tensor   # (E,)
    e_qual: torch.Tensor     # (E,) quality score scaling the Huber delta
    e_valid: torch.Tensor    # (E,) bool


class BAResult(NamedTuple):
    kf_pose: torch.Tensor
    pt_pos: torch.Tensor
    e_chi2: torch.Tensor       # final unrobust chi2 per edge
    e_depth_pos: torch.Tensor  # final positive-depth flag per edge
    e_inlier: torch.Tensor


def _edge_terms(kf_pose, pt_pos, e_kf, e_pt, e_obs, K):
    T = kf_pose[e_kf]                                    # (E, 4, 4)
    X = pt_pos[e_pt]                                     # (E, 3)
    pc = numerics.matmul(T[:, :3, :3], X[:, :, None])[..., 0] + T[:, :3, 3]
    is_stereo = e_obs[:, 2] >= 0
    e = e_obs - camera.project_stereo(K, pc)
    e = torch.cat([e[:, :2], torch.where(is_stereo, e[:, 2], 0.0)[:, None]], dim=1)
    return e, pc, T


def _chi2(e, inv_s2):
    return inv_s2 * se3.sum3(e, e)


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / determinant). Callers
    guard singular blocks themselves (dead point slots become identity)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = torch.reciprocal(torch.where(torch.abs(det) > 1e-30, det, 1e-30))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _mm64(a, b):
    """a @ b over a long inner axis, in float64 rounded once."""
    return numerics.rounded(torch.matmul, a, b)


def _point_table(e_pt, e_valid, n_pt):
    """(P, D) int64 table of each point's valid edges in edge order, padded
    with E (a zero row): a stable sort by point, then the k-th edge of point
    p at row start[p] + k. One host read (D, the most edges of a point)."""
    E = e_pt.shape[0]
    key = torch.where(e_valid, e_pt.long(), n_pt)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_pt + 1)[:n_pt]
    D = max(int(counts.max()), 1)
    start = torch.cumsum(counts, 0) - counts
    k = torch.arange(D, device=e_pt.device)
    pos = torch.clamp(start[:, None] + k[None, :], max=E - 1)
    return torch.where(k[None, :] < counts[:, None], order[pos], E)


class _Ctx:
    """The problem's fixed pieces and the LM machinery over it (the
    reference's _ba_ctx)."""

    def __init__(self, prob: BAProblem, K: camera.Intrinsics):
        self.prob = prob
        self.K = K
        dev = prob.kf_pose.device
        self.n_kf = n_kf = prob.kf_pose.shape[0]
        self.n_pt = n_pt = prob.pt_pos.shape[0]
        self.e_kf = prob.e_kf.long()
        self.e_pt = prob.e_pt.long()
        is_stereo = prob.e_obs[:, 2] >= 0
        self.is_stereo = is_stereo
        delta_base_sq = torch.where(is_stereo, DELTA_STEREO_SQ, DELTA_MONO_SQ)
        self.delta_sq = delta_base_sq * prob.e_qual * prob.e_qual
        self.chi2_th = delta_base_sq
        # camera-axis reductions as one-hot products (K <= 64)
        self.oh_kf = (self.e_kf[None, :] == torch.arange(n_kf, device=dev)[:, None]
                      ).to(torch.float32)
        self.table = _point_table(prob.e_pt, prob.e_valid, n_pt)
        # U's row of each edge; padded edges write a scratch row, dropped
        self.u_idx = torch.where(prob.e_valid, self.e_pt * n_kf + self.e_kf, n_pt * n_kf)
        self.fixed_e = prob.kf_fixed[self.e_kf]
        self.fixed6 = torch.repeat_interleave(prob.kf_fixed, 6)

    def edge_terms(self, kf_pose, pt_pos):
        return _edge_terms(kf_pose, pt_pos, self.e_kf, self.e_pt, self.prob.e_obs, self.K)

    def total_cost(self, kf_pose, pt_pos, mask, kernel_on):
        e, _, _ = self.edge_terms(kf_pose, pt_pos)
        rob = _huber_rho0(_chi2(e, self.prob.e_inv_s2), self.delta_sq, kernel_on)
        return numerics.total(torch.where(mask, rob, 0.0), dim=0)

    def point_sum(self, x):
        """(E, d) per-edge rows summed per point: (P, d), a float32 tree
        over each point's edges in edge order."""
        x = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return numerics.tree_sum(x[self.table].transpose(0, 1))

    def build(self, kf_pose, pt_pos, mask, kernel_on):
        """The normal equations at (kf_pose, pt_pos); returns (solve,
        max_diag), solve(lam) -> (dc, dp, scale)."""
        prob, K = self.prob, self.K
        n_kf, n_pt = self.n_kf, self.n_pt
        E = prob.e_obs.shape[0]
        e, pc, T = self.edge_terms(kf_pose, pt_pos)
        c2 = _chi2(e, prob.e_inv_s2)
        w = _huber_w(c2, self.delta_sq, kernel_on) * prob.e_inv_s2
        w = torch.where(mask, w, 0.0)

        Jp = camera.proj_jacobian_stereo(K, pc)                       # (E, 3, 3)
        Jp = torch.cat([Jp[:, :2], torch.where(self.is_stereo[:, None], Jp[:, 2], 0.0)
                        [:, None]], dim=1)
        # pose block: d e / d xi = Jproj [hat(pc) | -I]
        Jc = torch.cat([numerics.matmul(Jp, se3.hat(pc)), -Jp], dim=-1)  # (E, 3, 6)
        Jc = torch.where(self.fixed_e[:, None, None], 0.0, Jc)
        # point block: d e / d X = -Jproj Rcw
        Jx = -numerics.matmul(Jp, T[:, :3, :3])                        # (E, 3, 3)

        JcwT = (Jc * w[:, None, None]).transpose(-1, -2)               # (E, 6, 3)
        JxwT = (Jx * w[:, None, None]).transpose(-1, -2)
        Hcc = _mm64(self.oh_kf, numerics.matmul(JcwT, Jc).reshape(E, 36)).reshape(n_kf, 6, 6)
        gc = _mm64(self.oh_kf, -numerics.matmul(JcwT, e[..., None])[..., 0])   # (K, 6)
        Hpp = self.point_sum(numerics.matmul(JxwT, Jx).reshape(E, 9)).reshape(n_pt, 3, 3)
        gp = self.point_sum(-numerics.matmul(JxwT, e[..., None])[..., 0])       # (P, 3)

        max_diag = torch.maximum(
            torch.diagonal(Hcc, dim1=1, dim2=2).abs().amax(),
            torch.diagonal(Hpp, dim1=1, dim2=2).abs().amax())

        # lambda-independent pieces, built once an iteration
        B = numerics.matmul(JcwT, Jx)                                  # (E, 6, 3)
        U = torch.zeros((n_pt * n_kf + 1, 18), dtype=B.dtype, device=B.device)
        U[self.u_idx] = B.reshape(E, 18)
        U2 = U[:-1].reshape(n_pt, n_kf * 6, 3)
        U2f = U2.transpose(1, 2).reshape(n_pt * 3, n_kf * 6)
        dev = pc.device
        eye3 = torch.eye(3, device=dev)
        eye_k = torch.eye(n_kf, device=dev)
        gc_f, gp_f = gc.reshape(-1), gp.reshape(-1)
        fixed6 = self.fixed6
        pt_valid = prob.pt_valid

        def solve(lam):
            Hpp_d = Hpp + lam * eye3
            # guard dead point slots (all-zero blocks) against singularity
            dg = torch.diagonal(Hpp_d, dim1=1, dim2=2).abs()
            dead = (dg[:, 0] + dg[:, 1] + dg[:, 2]) < 1e-12
            Hpp_d = torch.where(dead[:, None, None], eye3, Hpp_d)
            Hinv = _inv3x3(Hpp_d)
            # TU[p, n, b] = sum_a U2[p, n, a] Hinv[p, a, b]
            TU = torch.stack([sum(U2[:, :, a] * Hinv[:, a, b][:, None] for a in range(3))
                              for b in range(3)], dim=-1)              # (P, 6K, 3)
            TUf = TU.transpose(1, 2).reshape(n_pt * 3, n_kf * 6)
            S_red = _mm64(TUf.T, U2f)                                  # (6K, 6K)
            Hcc_d = Hcc + lam * torch.eye(6, device=dev)
            S = (eye_k[:, None, :, None] * Hcc_d[:, :, None, :]).reshape(n_kf * 6, n_kf * 6)
            S = S - S_red
            rhs = gc_f - _mm64(TUf.T, gp_f[:, None])[:, 0]
            # fixed cameras: identity rows/cols, zero rhs
            S = torch.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
            S = S + torch.diag(torch.where(fixed6, 1.0, 1e-9))
            rhs = torch.where(fixed6, 0.0, rhs)
            # a singular system gives non-finite steps, which the trial rejects
            # (jnp.linalg.solve does not raise either); CUDA's solve would raise
            dc = numerics.rounded(lambda a, b: torch.linalg.solve_ex(a, b)[0], S,
                                  rhs).reshape(n_kf, 6)
            # back-substitute points: dp = Hpp^-1 (gp - U^T dc)
            Ut_dc = _mm64(U2f, dc.reshape(-1, 1)).reshape(n_pt, 3)
            dp = numerics.matmul(Hinv, (gp - Ut_dc)[..., None])[..., 0]
            dp = torch.where(pt_valid[:, None], dp, 0.0)
            # Powell's predicted decrease with the ORIGINAL gradient of every
            # block (g2o computeScale: dx^T (lambda dx + b))
            dcf = dc.reshape(-1)
            scale = (numerics.total(dcf * (lam * dcf + gc_f), dim=0)
                     + numerics.total((dp * (lam * dp + gp)).reshape(-1), dim=0))
            return dc, dp, scale

        return solve, max_diag

    def segment(self, kf_pose, pt_pos, lam, ni, chi, mask, kernel_on, n_iters, init):
        """n_iters LM iterations from (kf_pose, pt_pos) carrying (lam, ni,
        chi); with init (the start of a phase) chi is the cost at the start
        and lambda is seeded at the first iteration (1e-5 * max diag, g2o's
        tau). Returns (kf_pose, pt_pos, lam, ni, chi)."""
        fixed = self.prob.kf_fixed[:, None, None]
        if init:
            chi = self.total_cost(kf_pose, pt_pos, mask, kernel_on)
            lam = torch.zeros_like(chi)
            ni = torch.full_like(chi, 2.0)
        for it in range(n_iters):
            solve, max_diag = self.build(kf_pose, pt_pos, mask, kernel_on)
            if init and it == 0:
                lam = 1e-5 * max_diag
                ni = torch.full_like(lam, 2.0)
            rho, trials, done = -1.0, 0, False
            while not done and rho < 0 and trials < MAX_TRIALS:
                dc, dp, scale = solve(lam)
                kp_new = torch.where(fixed, kf_pose,
                                     numerics.matmul(se3.se3_exp(dc), kf_pose))
                pp_new = pt_pos + dp
                chi_new = self.total_cost(kp_new, pp_new, mask, kernel_on)
                rho_t = (chi - chi_new) / (scale + 1e-3)
                good_t = (rho_t > 0) & torch.isfinite(chi_new)
                a = 2.0 * rho_t - 1.0
                lam_good = lam * torch.clamp(1.0 - a * a * a, 1.0 / 3.0, 2.0 / 3.0)
                flag, rho = torch.stack([good_t.to(rho_t.dtype), rho_t]).tolist()
                done = flag != 0.0
                if done:
                    kf_pose, pt_pos, lam, chi = kp_new, pp_new, lam_good, chi_new
                    ni = torch.full_like(ni, 2.0)
                else:
                    lam, ni = lam * ni, ni * 2.0
                trials += 1
        return kf_pose, pt_pos, lam, ni, chi

    def midpoint(self, kf_pose, pt_pos):
        """The outlier gate between the phases (Optimizer.cc:786-817)."""
        e, pc, _ = self.edge_terms(kf_pose, pt_pos)
        c2 = _chi2(e, self.prob.e_inv_s2)
        return self.prob.e_valid & (c2 <= self.chi2_th) & (pc[:, 2] > 0)

    def finalize(self, kf_pose, pt_pos) -> BAResult:
        """The final classification (Optimizer.cc:820-850)."""
        e, pc, _ = self.edge_terms(kf_pose, pt_pos)
        c2 = _chi2(e, self.prob.e_inv_s2)
        depth_pos = pc[:, 2] > 0
        return BAResult(kf_pose=kf_pose, pt_pos=pt_pos, e_chi2=c2, e_depth_pos=depth_pos,
                        e_inlier=self.prob.e_valid & (c2 <= self.chi2_th) & depth_pos)


def ba_segment(prob: BAProblem, K: camera.Intrinsics, kf_pose, pt_pos, lam, ni, chi, mask,
               n_iters: int, kernel_on: bool = True, init: bool = False, ctx=None):
    """One LM segment of a phase: returns (kf_pose, pt_pos, lam, ni, chi).
    init=True starts the phase (lam, ni, chi are then ignored); init=False
    continues from the carried state. ``ctx``, the problem's ``_Ctx``, is
    built when not given (one host read)."""
    ctx = ctx or _Ctx(prob, K)
    return ctx.segment(kf_pose, pt_pos, lam, ni, chi, mask, kernel_on, n_iters, init)


def ba_midpoint(prob: BAProblem, K: camera.Intrinsics, kf_pose, pt_pos, ctx=None):
    """The between-phase outlier gate (Optimizer.cc:786-817): the inlier
    mask of phase 2."""
    return (ctx or _Ctx(prob, K)).midpoint(kf_pose, pt_pos)


def ba_finalize(prob: BAProblem, K: camera.Intrinsics, kf_pose, pt_pos, ctx=None) -> BAResult:
    """The final classification (Optimizer.cc:820-850)."""
    return (ctx or _Ctx(prob, K)).finalize(kf_pose, pt_pos)


def ba_solve(
    prob: BAProblem,
    K: camera.Intrinsics,
    n_iters1: int = 5,
    n_iters2: int = 10,
    kernel2: bool = False,
    midpoint_gate: bool = True,
) -> BAResult:
    """The reference's two BA flavours. LocalBundleAdjustment: optimize
    (n_iters1) with the robust kernel, the outlier gate, then optimize
    (n_iters2) on the inliers with the robust kernel REMOVED
    (Optimizer.cc:774, 790). Global BA (kernel2=True, midpoint_gate=False):
    one robust run over every valid edge (Optimizer.cc:51-249)."""
    ctx = _Ctx(prob, K)
    # phase 1: n_iters1 iterations on all valid edges, robust kernel on
    kf_pose, pt_pos, *_ = ctx.segment(prob.kf_pose, prob.pt_pos, None, None, None,
                                      prob.e_valid, True, n_iters1, init=True)
    # outlier gate between phases (Optimizer.cc:786-817)
    inlier = ctx.midpoint(kf_pose, pt_pos) if midpoint_gate else prob.e_valid
    # phase 2 on the inlier set; the local BA strips the robust kernel here
    # (setRobustKernel(0), Optimizer.cc:774,790)
    kf_pose, pt_pos, *_ = ctx.segment(kf_pose, pt_pos, None, None, None, inlier, kernel2,
                                      n_iters2, init=True)
    return ctx.finalize(kf_pose, pt_pos)
