"""Batched maximum-likelihood PnP + RANSAC (rebuild of src/MLPnPsolver.cpp).

Port of `amcslam_tpu/ransac/mlpnp.py`. Each unit bearing v_i gets a tangent
basis (r_i, s_i) and contributes the linear constraints
r_i^T (R p_i + t) = 0, s_i^T (R p_i + t) = 0, solved by SVD over the 12
unknowns [vec(R); t] (`computePose`, MLPnPsolver.cpp:356), then refined by
Gauss-Newton on SE(3) (`mlpnp_gn`, :694) inside a RANSAC loop (`iterate`,
:100). Relocalization uses it (pipeline/tracking.py).

The reference vmaps one hypothesis at a time; here every function is batched
over a leading hypothesis axis H. The reference differentiates the GN
residual with `jax.jacfwd`; here the 2N x 6 Jacobian is written out (the
same derivative, d(T exp(d) p)/dd = R [I, -[p]x] at d = 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie


def _nullspace_basis(v: torch.Tensor):
    """Tangent basis (r, s) orthogonal to unit bearings v (..., 3)."""
    # pick the axis least aligned with v for numerical stability
    ex = v.new_tensor([1.0, 0.0, 0.0])
    ey = v.new_tensor([0.0, 1.0, 0.0])
    ref = torch.where((v[..., 0].abs() < 0.9)[..., None], ex, ey)
    r = torch.linalg.cross(v, ref.expand_as(v))
    r = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    s = torch.linalg.cross(v, r)
    return r, s


def mlpnp_dlt(points: torch.Tensor, bearings: torch.Tensor):
    """Closed-form (R, t) from n >= 6 correspondences via the nullspace DLT.

    points (H,n,3) world points, bearings (H,n,3) unit bearings in the camera
    frame. Returns R (H,3,3), t (H,3). The SVD's null vector has an arbitrary
    sign; the depth vote below fixes it, so R and t do not depend on it."""
    H, n, _ = points.shape
    r, s = _nullspace_basis(bearings)
    # rows for unknowns [vec(R) (column-major), t]: r^T R p = (p kron r)^T vec(R)
    kr = (points[..., :, None] * r[..., None, :]).reshape(H, n, 9)
    ks = (points[..., :, None] * s[..., None, :]).reshape(H, n, 9)
    rows = torch.stack([torch.cat([kr, r], -1), torch.cat([ks, s], -1)], dim=2)
    A = rows.reshape(H, 2 * n, 12)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    x = Vh[:, -1]
    # x[:9] is vec(R) in column-major order (see the kron rows above)
    R_raw = x[:, :9].reshape(H, 3, 3).transpose(1, 2)
    t_raw = x[:, 9:]
    # sign: depths along bearings must be positive for the majority
    Xc = torch.einsum("hij,hnj->hni", R_raw, points) + t_raw[:, None, :]
    depths = (bearings * Xc).sum(-1)
    flip = (depths < 0).sum(-1) > n // 2
    sign = torch.where(flip, -1.0, 1.0).to(points.dtype)
    R_raw = R_raw * sign[:, None, None]
    t_raw = t_raw * sign[:, None]
    # project to SO(3) and rescale t by the mean singular value
    U, w, Vt2 = torch.linalg.svd(R_raw)
    d = torch.linalg.det(U @ Vt2)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt2
    scale = w.mean(-1)
    t = t_raw / torch.clamp(scale, min=1e-12)[:, None]
    return R, t


def _gn_residual_jac(T, points, r, s, sw):
    """Nullspace residuals (H,n,2) and their Jacobians (H,n,2,6) with respect
    to a right perturbation T exp(d) at d = 0."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    Xc = torch.einsum("hij,hnj->hni", R, points) + t[:, None, :]
    nrm = torch.linalg.vector_norm(Xc, dim=-1)
    live = nrm > 1e-12
    n = torch.clamp(nrm, min=1e-12)
    B = torch.stack([r, s], dim=-2)                       # (H,n,2,3)
    BX = torch.einsum("hnki,hni->hnk", B, Xc)             # (H,n,2)
    e = BX / n[..., None] * sw[..., None]
    # d(BX/n)/dXc = B/n - (BX) Xc^T / n^3 (the clamp has no derivative)
    dn = torch.where(live, 1.0 / n**3, torch.zeros_like(n))
    de_dX = (B / n[..., None, None]
             - BX[..., :, None] * Xc[..., None, :] * dn[..., None, None]) * sw[..., None, None]
    # dXc/dd = R [I, -[p]x]
    dXc = torch.cat([R[:, None].expand(-1, points.shape[1], -1, -1),
                     -R[:, None] @ lie.hat(points)], dim=-1)  # (H,n,3,6)
    return e, de_dX @ dXc


def mlpnp_gn(R, t, points, bearings, weights, n_iters: int = 5):
    """Gauss-Newton refinement of the nullspace residuals on SE(3).

    Minimizes sum_i w_i || [r_i; s_i]^T (R p_i + t) / |R p_i + t| ||^2 with a
    right-multiplicative retraction (mlpnp_gn, MLPnPsolver.cpp:694ff).
    Batched: R (H,3,3), t (H,3), points/bearings (H,n,3), weights (H,n)."""
    H, n, _ = points.shape
    T = lie.se3_matrix(R, t)
    r, s = _nullspace_basis(bearings)
    sw = torch.sqrt(weights)
    eye = torch.eye(6, dtype=points.dtype, device=points.device)
    for _ in range(n_iters):
        e, J = _gn_residual_jac(T, points, r, s, sw)
        J = J.reshape(H, 2 * n, 6)
        e = e.reshape(H, 2 * n)
        Hm = J.transpose(1, 2) @ J + 1e-9 * eye
        g = torch.einsum("hki,hk->hi", J, e)
        # a singular system gives a NaN step, as jnp.linalg.solve's inf/NaN
        dx, info = torch.linalg.solve_ex(Hm, -g)
        dx = torch.where((info == 0)[:, None], dx, torch.full_like(dx, float("nan")))
        T = T @ lie.exp_se3(dx)
    return T[:, :3, :3], T[:, :3, 3]


class PnPRansacData(NamedTuple):
    points: torch.Tensor    # (N,3) world points
    bearings: torch.Tensor  # (N,3) unit bearings (camera frame)
    obs: torch.Tensor       # (N,2) pixel observations (for inlier check)
    K: torch.Tensor         # (4,) pinhole intrinsics
    w: torch.Tensor         # (N,) weights (invSigma2)
    valid: torch.Tensor     # (N,) bool
    th2: torch.Tensor       # (N,) per-point squared pixel threshold


def pnp_ransac(data: PnPRansacData, samples: torch.Tensor, refine_iters: int = 5):
    """All-hypotheses-parallel MLPnP RANSAC. samples: (H,6) int64.

    Returns ((R, t) camera-from-world of the best hypothesis, inlier mask,
    count); the best is the first of the highest counts, as jnp.argmax.
    MLPnPsolver::iterate's structure: minimal solve + GN + reprojection
    gating."""
    R, t = mlpnp_dlt(data.points[samples], data.bearings[samples])
    R, t = mlpnp_gn(R, t, data.points[samples], data.bearings[samples],
                    data.w[samples], refine_iters)
    Xc = torch.einsum("hij,nj->hni", R, data.points) + t[:, None, :]
    u = data.K[0] * Xc[..., 0] / Xc[..., 2] + data.K[2]
    v = data.K[1] * Xc[..., 1] / Xc[..., 2] + data.K[3]
    err = (u - data.obs[:, 0]) ** 2 + (v - data.obs[:, 1]) ** 2
    inl = (err < data.th2) & (Xc[..., 2] > 0) & data.valid
    n_in = inl.sum(-1)
    best = torch.argmax(n_in)
    return (R[best], t[best]), inl[best], n_in[best]
