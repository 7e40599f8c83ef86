"""Monocular two-view initializer (TwoViewReconstruction.cc), in PyTorch.

Port of `amcslam_tpu/ransac/two_view.py`: 8-point fundamental and 4-point
homography RANSAC with symmetric-transfer scoring, model selection
RH = SH / (SH + SF), and motion recovery: E decomposition (4 motions) or
the Faugeras homography decomposition (8 motions), each checked for
cheirality by triangulating every match. As in the reference, all
hypotheses of both models score in one batch, and all 12 candidate motions
triangulate in one batched 4x4 SVD (frontend/cameras.triangulate_dlt). The
caller passes the RANSAC samples, so draws are the caller's.

Singular vectors are defined up to sign, and LAPACK, cuSOLVER and XLA each
pick one. F (a null vector) is then defined up to sign, H is normalized by
H[2, 2] and does not depend on it; a sign flip of E's or of the
homography's singular vectors permutes the 4 or 8 candidate motions
without changing the set, so the chosen motion is the same. `argmax`
takes the first maximum, as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend.cameras import triangulate_dlt
from ..ops import lie

TH_F = 3.841
TH_SCORE = 5.991
TH_H = 5.991


class TwoViewData(NamedTuple):
    kp1: torch.Tensor    # (N,2) pixel coords in image 1
    kp2: torch.Tensor    # (N,2)
    valid: torch.Tensor  # (N,) bool
    K: torch.Tensor      # (4,) fx, fy, cx, cy
    sigma: torch.Tensor  # () pixel noise scale


class TwoViewResult(NamedTuple):
    ok: torch.Tensor            # () bool
    used_homography: torch.Tensor
    R: torch.Tensor             # (3,3) T21 rotation
    t: torch.Tensor             # (3,)
    X: torch.Tensor             # (N,3) triangulated points
    triangulated: torch.Tensor  # (N,) bool
    n_good: torch.Tensor


def _K_matrix(K4):
    z, o = torch.zeros_like(K4[0]), torch.ones_like(K4[0])
    return torch.stack([torch.stack([K4[0], z, K4[2]]), torch.stack([z, K4[1], K4[3]]),
                        torch.stack([z, z, o])])


def _homog(kp):
    return torch.cat([kp, torch.ones_like(kp[..., :1])], -1)


def _normalize(kp, valid):
    """Hartley normalization with the mean absolute deviation (Normalize())."""
    n = torch.clamp(valid.sum(), min=1)
    v = valid[:, None]
    mean = torch.where(v, kp, torch.zeros_like(kp)).sum(0) / n
    dev = torch.where(v, (kp - mean).abs(), torch.zeros_like(kp)).sum(0) / n
    s = 1.0 / torch.clamp(dev, min=1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (kp - mean) * s, T


def _fundamental_8pt(p1, p2):
    """F from 8 normalized correspondences (ComputeF21): the null vector of
    the (..., 8, 9) system, then rank 2."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                    -1)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    F = Vh[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    U, w, Vh2 = torch.linalg.svd(F)
    w = torch.cat([w[..., :2], torch.zeros_like(w[..., 2:])], -1)
    return (U * w[..., None, :]) @ Vh2


def _homography_4pt(p1, p2):
    """H from the first 4 normalized correspondences (ComputeH21 DLT)."""
    u1, v1 = p1[..., :4, 0], p1[..., :4, 1]
    u2, v2 = p2[..., :4, 0], p2[..., :4, 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    _, _, Vh = torch.linalg.svd(torch.cat([r1, r2], -2), full_matrices=True)  # (...,8,9)
    return Vh[..., -1, :].reshape(*u1.shape[:-1], 3, 3)


def _score_F(F, data: TwoViewData):
    """CheckFundamental (TwoViewReconstruction.cc:395-473): symmetric epipolar
    transfer, th = 3.841, score term thScore = 5.991. F (..., 3, 3) ->
    (score (...,), good (..., N))."""
    inv_s2 = 1.0 / (data.sigma * data.sigma)
    x1, x2 = _homog(data.kp1), _homog(data.kp2)
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    l2 = x1 @ F.transpose(-1, -2)  # lines in image 2
    num2 = (l2 * x2).sum(-1)
    d1 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-18)
    l1 = x2 @ F
    num1 = (l1 * x1).sum(-1)
    d2 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-18)
    c1, c2 = d1 * inv_s2, d2 * inv_s2
    in1, in2 = data.valid & (c1 <= TH_F), data.valid & (c2 <= TH_F)
    score = (torch.where(in1, TH_SCORE - c1, zero) + torch.where(in2, TH_SCORE - c2, zero)).sum(-1)
    return score, (c1 <= TH_F) & (c2 <= TH_F) & data.valid


def _score_H(H, data: TwoViewData):
    """CheckHomography: symmetric reprojection error, th = 5.991."""
    inv_s2 = 1.0 / (data.sigma * data.sigma)
    x1, x2 = _homog(data.kp1), _homog(data.kp2)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)

    def dehom(p):
        w = p[..., 2:]
        return p[..., :2] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))

    d1 = ((data.kp2 - dehom(x1 @ H.transpose(-1, -2))) ** 2).sum(-1) * inv_s2
    d2 = ((data.kp1 - dehom(x2 @ torch.linalg.inv(H).transpose(-1, -2))) ** 2).sum(-1) * inv_s2
    in1, in2 = data.valid & (d1 <= TH_H), data.valid & (d2 <= TH_H)
    score = (torch.where(in1, TH_H - d1, zero) + torch.where(in2, TH_H - d2, zero)).sum(-1)
    return score, (d1 <= TH_H) & (d2 <= TH_H) & data.valid


def _decompose_E(E):
    """The motions (R1, t), (R2, t), (R1, -t), (R2, -t) (DecomposeE)."""
    U, _, Vh = torch.linalg.svd(E)
    t = U[:, 2] / torch.linalg.norm(U[:, 2])
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vh
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vh
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _faugeras_motions(H, K4):
    """The 8 (R, t) candidates of a homography (ReconstructH) and whether it
    is degenerate."""
    Km = _K_matrix(K4)
    Kinv = torch.linalg.inv(Km)
    U, w, Vh = torch.linalg.svd(Kinv @ H @ Km)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = w[0], w[1], w[2]
    degenerate = (d1 / d2 < 1.00001) | (d2 / d3 < 1.00001)

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), min=0.0))
    x1v = torch.stack([aux1, aux1, -aux1, -aux1])
    x3v = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = root / ((d1 + d3) * d2)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    sthetav = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    aux_sp = root / ((d1 - d3) * d2)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sphiv = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])

    z, o = torch.zeros_like(x1v), torch.ones_like(x1v)
    cth, cph = ctheta.expand(4), cphi.expand(4)
    Rp_pos = torch.stack([torch.stack([cth, z, -sthetav], -1), torch.stack([z, o, z], -1),
                          torch.stack([sthetav, z, cth], -1)], -2)
    Rp_neg = torch.stack([torch.stack([cph, z, sphiv], -1), torch.stack([z, -o, z], -1),
                          torch.stack([sphiv, z, -cph], -1)], -2)
    tp_pos = torch.stack([x1v, z, -x3v], -1) * (d1 - d3)
    tp_neg = torch.stack([x1v, z, x3v], -1) * (d1 + d3)
    Rs = s * (U @ torch.cat([Rp_pos, Rp_neg]) @ Vh)
    ts = (U @ torch.cat([tp_pos, tp_neg])[..., None])[..., 0]
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs, ts, degenerate


def _check_rt(Rs, ts, data: TwoViewData, inliers, th2_reproj):
    """CheckRT for a batch of C motions at once: triangulate every match
    under each (R, t) and count the inlier matches with positive depth in
    both views, a bounded reprojection error and finite parallax. Returns
    (n_good (C,), X (C,N,3), good (C,N), parallax in degrees (C,))."""
    C, N = Rs.shape[0], data.kp1.shape[0]
    Km = _K_matrix(data.K)
    Kinv = torch.linalg.inv(Km)
    r1 = _homog(data.kp1) @ Kinv.T
    r2 = _homog(data.kp2) @ Kinv.T
    r1 = (r1 / r1[:, 2:]).expand(C, N, 3).reshape(C * N, 3)
    r2 = (r2 / r2[:, 2:]).expand(C, N, 3).reshape(C * N, 3)
    eye4 = torch.eye(4, dtype=Rs.dtype, device=Rs.device)
    Tcw2 = lie.se3_matrix(Rs, ts)[:, None].expand(C, N, 4, 4).reshape(C * N, 4, 4)
    X, _ = triangulate_dlt(r1, r2, eye4.expand(C * N, 4, 4), Tcw2)
    X = X.reshape(C, N, 3)
    Xc2 = X @ Rs.transpose(-1, -2) + ts[:, None, :]
    # parallax between the two rays
    n1 = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-12)
    O2 = -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]
    d2v = X - O2[:, None, :]
    n2 = d2v / torch.clamp(torch.linalg.norm(d2v, dim=-1, keepdim=True), min=1e-12)
    cos_par = (n1 * n2).sum(-1)
    p1 = X @ Km.T
    e1 = ((p1[..., :2] / p1[..., 2:] - data.kp1) ** 2).sum(-1)
    p2 = Xc2 @ Km.T
    e2 = ((p2[..., :2] / p2[..., 2:] - data.kp2) ** 2).sum(-1)
    ok = (torch.isfinite(X).all(-1) & (X[..., 2] > 0) & (Xc2[..., 2] > 0)
          & (cos_par < 0.99998) & (e1 < th2_reproj) & (e2 < th2_reproj) & inliers)
    n_good = ok.sum(-1)
    # the parallax of the 50th-smallest cosine among the good points (or the
    # largest if there are fewer)
    cp_sorted, _ = torch.sort(torch.where(ok, cos_par, torch.ones_like(cos_par)), dim=-1)
    idx = torch.clamp(torch.clamp(n_good - 1, min=0), max=49)
    cp = cp_sorted.gather(-1, idx[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cp, -1.0, 1.0)))
    return n_good, X, ok, parallax


def reconstruct(data: TwoViewData, samples: torch.Tensor, min_parallax: float = 1.0,
                min_triangulated: int = 50) -> TwoViewResult:
    """Two-view reconstruction (Reconstruct, TwoViewReconstruction.cc:41-130)
    from RANSAC `samples` (H, 8) match indices: every hypothesis of both
    models, then the selected model's candidate motions (4 for E, 8 for H),
    evaluated in one batch each."""
    kpn1, T1 = _normalize(data.kp1, data.valid)
    kpn2, T2 = _normalize(data.kp2, data.valid)
    p1, p2 = kpn1[samples], kpn2[samples]  # (H,8,2)
    F_h = T2.T @ _fundamental_8pt(p1, p2) @ T1
    sF_h, _ = _score_F(F_h, data)
    H_h = torch.linalg.inv(T2) @ _homography_4pt(p1, p2) @ T1
    h22 = H_h[:, 2:3, 2:3]
    H_h = H_h / torch.where(h22.abs() > 1e-12, h22, torch.full_like(h22, 1e-12))
    sH_h, _ = _score_H(H_h, data)
    bi_F, bi_H = torch.argmax(sF_h), torch.argmax(sH_h)
    F, H = F_h[bi_F], H_h[bi_H]
    SF, SH = sF_h[bi_F], sH_h[bi_H]
    _, inl_F = _score_F(F, data)
    _, inl_H = _score_H(H, data)
    use_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.50

    Km = _K_matrix(data.K)
    R1, R2, tE = _decompose_E(Km.T @ F @ Km)
    RsH, tsH, h_degenerate = _faugeras_motions(H, data.K)
    Rs = torch.cat([torch.stack([R1, R2, R1, R2]), RsH])  # (12,3,3)
    ts = torch.cat([torch.stack([tE, tE, -tE, -tE]), tsH])
    inliers = torch.where(use_H, inl_H, inl_F)
    n_good, Xs, good, par = _check_rt(Rs, ts, data, inliers, 4.0 * data.sigma * data.sigma)

    ar = torch.arange(12, device=Rs.device)
    cand = torch.where(use_H, ar >= 4, ar < 4)
    n_masked = torch.where(cand, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_masked)
    max_good = n_masked[best]
    dtype = Rs.dtype
    n_min_good = torch.clamp((0.9 * inliers.sum().to(dtype)).to(torch.int64), min=min_triangulated)
    n_similar = (cand & (n_good.to(dtype) > 0.7 * max_good.to(dtype))).sum()
    ok = ((max_good >= n_min_good) & (n_similar == 1) & (par[best] > min_parallax)
          & ~(use_H & h_degenerate))
    return TwoViewResult(ok=ok, used_homography=use_H, R=Rs[best], t=ts[best], X=Xs[best],
                         triangulated=good[best], n_good=max_good)
