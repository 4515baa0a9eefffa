"""Monocular map initialization (src/Initializer.cc re-designed).

Port of ``iv_slam_tpu/solvers/initializer.py``. The reference races a
homography and a fundamental-matrix model over 200 8-point RANSAC
hypotheses, picks by score ratio RH = SH/(SH+SF) > 0.40, then recovers
motion (Faugeras decomposition for H, essential decomposition for F) and
triangulates (Initializer.cc:25-931). Every hypothesis is one batched
normalized DLT, model scoring a (hyp, N) masked reduction, and the eight
motion candidates are checked in one batched triangulation pass.

The reference draws its 8-point samples with ``jax.random`` under
``PRNGKey(frame_id)``, which torch cannot reproduce. So the RANSAC is
split: ``sample_init`` draws the (200, 8) index array from a CPU
``torch.Generator`` seeded with the frame id (the card and the CPU path
draw alike) and ``initialize_mono`` scores the hypotheses of any index
array a caller gives it; ``Tracking.init_sampler`` names the sampler in
use, and the parity tests install JAX's draws.

Everything runs in float64 and the results (R, t, points) are rounded once
to float32, so the card and the CPU path agree: scores, thresholds and the
candidate choice are float64 decisions. The null vectors of the DLT and
triangulation systems are eigenvectors of AᵀA, whose sign each library
picks freely; every use of them is sign-invariant. The singular vectors of
the 3x3 decompositions are made unique (each pair (u_i, v_i) turned so
that v_i's largest entry is positive), which fixes the candidates' order
on every device. The reference works in float32 with its own SVD signs, so
its R, t and points differ from these by float32 rounding and its
candidates may come in another order; the chosen candidate is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pnp

TH_H = 5.991   # symmetric-transfer chi2 threshold, homography
TH_F = 3.841   # point-line chi2 threshold, fundamental
TH_SCORE = 5.991  # score saturation for both (Initializer.cc CheckFundamental)
N_HYP = 200


class InitResult(NamedTuple):
    ok: torch.Tensor          # () bool
    R: torch.Tensor           # (3, 3) R21
    t: torch.Tensor           # (3,) t21 (unit norm)
    points: torch.Tensor      # (N, 3) triangulated points in frame-1 coords
    is_good: torch.Tensor     # (N,) triangulated + checks passed
    used_homography: torch.Tensor
    best_h: torch.Tensor      # () index of the best homography hypothesis
    best_f: torch.Tensor      # () index of the best fundamental hypothesis
    inliers: torch.Tensor     # (N,) inliers of the chosen model


def sample_init(key_id: int, valid, device=None, n_hyp: int = N_HYP) -> torch.Tensor:
    """(n_hyp, 8) int64 sample indices, each row 8 distinct valid matches
    drawn uniformly, from a CPU generator seeded with key_id (the
    reference's ``jax.random.choice(..., replace=False, p=valid/n)``)."""
    return pnp.sample_pnp(key_id, valid, n_hyp=n_hyp, sample_size=8, device=device)


def _normalize(pts: torch.Tensor):
    """Hartley normalization of (N, 2) points: mean to 0, mean absolute
    deviation to 1. Returns (normalized points, 3x3 T)."""
    mean = pts.mean(dim=0)
    d = torch.abs(pts - mean).mean(dim=0)
    s = 1.0 / torch.clamp(d, min=1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., M, K) -> (..., K): the unit vector minimizing |A x| (the right
    singular vector of the least singular value), any sign."""
    return torch.linalg.eigh(A.mT @ A)[1][..., :, 0]


def _dlt_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point homographies from (..., 8, 2) normalized pairs."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rows2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _dlt_f(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental matrices from (..., 8, 2) normalized pairs,
    forced to rank 2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., :, None] * Vt)


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _score_h(H21: torch.Tensor, p1, p2, valid):
    """Symmetric transfer scores of (..., 3, 3) homographies: (score (...),
    inliers (..., N))."""
    H12 = torch.linalg.inv(H21)

    def transfer(H, a, b):
        proj = _homog(a) @ H.mT
        proj = proj[..., :2] / proj[..., 2:3]
        return ((b - proj) ** 2).sum(dim=-1)

    e1 = transfer(H12, p2, p1)
    e2 = transfer(H21, p1, p2)
    ok = (e1 < TH_H) & (e2 < TH_H) & valid
    score = (torch.where(valid & (e1 < TH_H), TH_SCORE - e1, 0.0)
             + torch.where(valid & (e2 < TH_H), TH_SCORE - e2, 0.0))
    return score.sum(dim=-1), ok


def _score_f(F21: torch.Tensor, p1, p2, valid):
    """Point-to-epipolar-line scores of (..., 3, 3) fundamental matrices:
    (score (...), inliers (..., N))."""
    p1h, p2h = _homog(p1), _homog(p2)
    l2 = p1h @ F21.mT                # epipolar lines in image 2
    l1 = p2h @ F21                   # lines in image 1
    d2 = (p2h * l2).sum(dim=-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = (p1h * l1).sum(dim=-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    ok = (d1 < TH_F) & (d2 < TH_F) & valid
    score = (torch.where(valid & (d1 < TH_F), TH_SCORE - d1, 0.0)
             + torch.where(valid & (d2 < TH_F), TH_SCORE - d2, 0.0))
    return score.sum(dim=-1), ok


def _svd3(A: torch.Tensor):
    """SVD of a 3x3 matrix with each singular pair turned so that the
    largest-magnitude entry of v_i is positive (a unique basis)."""
    U, S, Vt = torch.linalg.svd(A)
    big = torch.gather(Vt, 1, torch.argmax(torch.abs(Vt), dim=1, keepdim=True))[:, 0]
    sgn = torch.where(big < 0, -1.0, 1.0).to(A.dtype)
    return U * sgn[None, :], S, Vt * sgn[:, None]


def _triangulate(R, t, K, p1, p2):
    """Linear triangulation of matched pixels (N, 2) into frame-1 coords,
    batched over leading axes of R (..., 3, 3), t (..., 3)."""
    P1 = K @ torch.eye(3, 4, dtype=K.dtype, device=K.device)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)              # (..., 3, 4)
    P1 = P1.expand_as(P2)
    a = p1[..., None]                                         # (N, 2, 1)
    b = p2[..., None]
    A = torch.stack([
        a[:, 0] * P1[..., None, 2, :] - P1[..., None, 0, :],
        a[:, 1] * P1[..., None, 2, :] - P1[..., None, 1, :],
        b[:, 0] * P2[..., None, 2, :] - P2[..., None, 0, :],
        b[:, 1] * P2[..., None, 2, :] - P2[..., None, 1, :],
    ], dim=-2)                                                # (..., N, 4, 4)
    X = _null_vector(A)
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w, 1e-12)


def _decompose_h(H21: torch.Tensor, K: torch.Tensor):
    """Faugeras (1988) homography decomposition into 8 (R, t) hypotheses
    (the reference's Initializer::ReconstructH candidate set)."""
    A = torch.linalg.inv(K) @ H21 @ K
    U, S, Vt = _svd3(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    sg1 = (1.0, 1.0, -1.0, -1.0)
    sg3 = (1.0, -1.0, 1.0, -1.0)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    z, o = torch.zeros_like(d1), torch.ones_like(d1)

    Rs, ts = [], []
    # case d' = d2, then d' = -d2
    for case in (1.0, -1.0):
        den = torch.clamp((d1 + case * d3) * d2, min=1e-12)
        base = root / den
        c = (case * d2 * d2 + d1 * d3) / den if case > 0 else (d1 * d3 - d2 * d2) / den
        for i in range(4):
            x1, x3 = sg1[i] * aux1, sg3[i] * aux3
            eps = torch.sign(x1 * x3 + 1e-20)
            st = eps * base
            if case > 0:
                Rp = torch.stack([torch.stack([c, z, -st]), torch.stack([z, o, z]),
                                  torch.stack([st, z, c])])
                tp = (d1 - d3) * torch.stack([x1, z, -x3])
            else:
                Rp = torch.stack([torch.stack([c, z, st]), torch.stack([z, -o, z]),
                                  torch.stack([st, z, -c])])
                tp = (d1 + d3) * torch.stack([x1, z, x3])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
    R_stack = torch.stack(Rs)
    t_stack = torch.stack(ts)
    t_stack = t_stack / torch.clamp(torch.linalg.norm(t_stack, dim=1, keepdim=True), min=1e-12)
    return R_stack, t_stack


def _check_rt(R, t, K, p1, p2, valid, sigma2=1.0):
    """Initializer::CheckRT over candidates (C, 3, 3), (C, 3): which points
    triangulate in front of both cameras, reproject within 2 sigma in both
    images and show parallax. Returns (good (C, N), X (C, N, 3))."""
    X = _triangulate(R, t, K, p1, p2)
    z1 = X[..., 2]
    Xc2 = X @ R.mT + t[:, None, :]
    z2 = Xc2[..., 2]
    finite = torch.isfinite(X).all(dim=-1)

    def project(P):
        return torch.stack([K[0, 0] * P[..., 0] / P[..., 2] + K[0, 2],
                            K[1, 1] * P[..., 1] / P[..., 2] + K[1, 2]], dim=-1)

    e1 = ((project(X) - p1) ** 2).sum(dim=-1)
    e2 = ((project(Xc2) - p2) ** 2).sum(dim=-1)
    O2 = -(R.mT @ t[..., None])[..., 0]                        # (C, 3)
    n1 = X
    n2 = X - O2[:, None, :]
    cos_par = (n1 * n2).sum(dim=-1) / torch.clamp(
        torch.linalg.norm(n1, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    good = (valid & finite & (z1 > 0) & (z2 > 0)
            & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2) & (cos_par < 0.99998))
    return good, X


def initialize_mono(
    p1: torch.Tensor,      # (N, 2) float32 keypoints in frame 1
    p2: torch.Tensor,      # (N, 2) matched keypoints in frame 2
    valid: torch.Tensor,   # (N,) bool
    K: torch.Tensor,       # (3, 3)
    idx: torch.Tensor,     # (n_hyp, 8) sample indices (sample_init)
) -> InitResult:
    """H/F model race over the hypotheses of `idx`, motion recovery and
    triangulation. No host synchronisation."""
    f64 = torch.float64
    p1, p2, K = p1.to(f64), p2.to(f64), K.to(f64)
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    idx = idx.to(p1.device)

    Hs = torch.linalg.inv(T2) @ _dlt_h(p1n[idx], p2n[idx]) @ T1      # (n_hyp, 3, 3)
    Fs = T2.T @ _dlt_f(p1n[idx], p2n[idx]) @ T1
    sh, _ = _score_h(Hs, p1, p2, valid)
    sf, _ = _score_f(Fs, p1, p2, valid)
    best_h = torch.argmax(sh)          # the first maximum
    best_f = torch.argmax(sf)
    SH, SF = sh[best_h], sf[best_f]
    H21, F21 = Hs[best_h], Fs[best_f]
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    _, inl_h = _score_h(H21, p1, p2, valid)
    _, inl_f = _score_f(F21, p1, p2, valid)
    model_inl = torch.where(use_h, inl_h, inl_f)

    # motion hypotheses: Faugeras decomposition (8) for the H model,
    # essential decomposition (4, each twice) for the F model
    E = K.T @ F21 @ K
    U, _S, Vt = _svd3(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=f64, device=p1.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = U[:, 2]
    tu = tu / torch.clamp(torch.linalg.norm(tu), min=1e-12)
    cands_R_f = torch.stack([R1, R1, R2, R2, R1, R1, R2, R2])
    cands_t_f = torch.stack([tu, -tu, tu, -tu, tu, -tu, tu, -tu])
    cands_R_h, cands_t_h = _decompose_h(H21, K)
    cands_R = torch.where(use_h, cands_R_h, cands_R_f)
    cands_t = torch.where(use_h, cands_t_h, cands_t_f)

    goods, Xs = _check_rt(cands_R, cands_t, K, p1, p2, model_inl)
    counts = goods.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts)
    n_best = counts[best]
    n_inl = model_inl.sum(dtype=torch.int32)
    # acceptance (Initializer::ReconstructF): one clearly-best decomposition
    # (no other candidate above 0.7 * best), >= 90% of inliers triangulated
    # and at least 50 points; the float32 products as the reference's
    n_similar = (counts.float() > 0.7 * n_best.float()).sum(dtype=torch.int32)
    need = torch.clamp((0.9 * n_inl.float()).to(torch.int32), min=50)
    ok = (n_similar == 1) & (n_best >= need)
    return InitResult(ok=ok, R=cands_R[best].float(), t=cands_t[best].float(),
                      points=Xs[best].float(), is_good=goods[best], used_homography=use_h,
                      best_h=best_h, best_f=best_f, inliers=model_inl)
