"""Small prior/regularizer factors (port of `amcslam_tpu/factors/priors.py`).

  * velocity regularizer    — EdgeVelocity: soft zero prior on the vertical
    (z) translational velocity, info = QcInv[2,2].
  * extrinsic rotation prior — EdgeExtrinsicPrior.
  * velocity-only reprojection — EdgeVelReproj, the residual of the
    MC-RANSAC velocity model (ransac/vel_ransac.py).

Batched over leading dimensions.
"""

from __future__ import annotations

import torch

from ..ops import lie
from .reprojection import project_jac_pinhole, project_pinhole


def velocity_residual(v: torch.Tensor) -> torch.Tensor:
    """r = v[2] (selects vertical velocity; A = [0,0,1,0,0,0])."""
    return v[..., 2:3]


def velocity_jac(v: torch.Tensor) -> torch.Tensor:
    """(..., 1, 12) Jacobian wrt the pose-vel vertex: d r / d v[2] = 1."""
    J = torch.zeros(*v.shape[:-1], 1, 12, dtype=v.dtype, device=v.device)
    J[..., 0, 8].fill_(1.0)  # slot 6+2 in [dxi(6), dv(6)]
    return J


def extrinsic_prior_residual(Tbc: torch.Tensor, R_prior: torch.Tensor) -> torch.Tensor:
    """r = log(R_prior^-1 * Rbc)  (rotation-only extrinsic anchor)."""
    return lie.log_so3(R_prior.transpose(-1, -2) @ Tbc[..., :3, :3])


def extrinsic_prior_jac(Tbc: torch.Tensor, R_prior: torch.Tensor) -> torch.Tensor:
    """(..., 3, 6) Jacobian wrt Tbc <- Tbc exp(de): [0, Jr^-1(r)]."""
    Jr_inv = lie.right_jacobian_so3_inv(extrinsic_prior_residual(Tbc, R_prior))
    return torch.cat([torch.zeros_like(Jr_inv), Jr_inv], -1)


def vel_reproj_residual(v, T, dt, Tbc, K, Xw, obs):
    """err = obs - pi((T exp(v dt) Tbc)^-1 Xw)  (EdgeVelReproj::computeError)."""
    Twc = T @ lie.exp_se3(v * dt[..., None]) @ Tbc
    Xc = lie.transform_point(lie.se3_inv(Twc), Xw)
    return obs - project_pinhole(K, Xc)


def _vel_reproj_point(v, T, dt, Tbc, Xw):
    """(dxi, Tcb1, Xb, Xc) of the velocity model: dxi = v dt,
    Tcb1 = Tbc^-1 exp(-dxi), Xb = T^-1 Xw, Xc = Tcb1 Xb."""
    dxi = v * dt[..., None]
    Tcb1 = lie.se3_inv(Tbc) @ lie.exp_se3(-dxi)
    Xb = lie.transform_point(lie.se3_inv(T), Xw)
    return dxi, Tcb1, Xb, lie.transform_point(Tcb1, Xb)


def vel_reproj_point_residual(v, T, dt, Tbc, K, Xw, obs):
    """The residual of `vel_reproj_jac` without its Jacobian (same arithmetic,
    so the inlier test sees the values the fit saw)."""
    return obs - project_pinhole(K, _vel_reproj_point(v, T, dt, Tbc, Xw)[3])


def vel_reproj_jac(v, T, dt, Tbc, K, Xw, obs):
    """Residual + (..., 2, 6) Jacobian wrt the twist vertex (G2oTypes.cc:497-510):
    pj * [Tcb exp(-v dt) CircleDot(Xb) Jr(-v dt) dt]_{3x6}, Xb = T^-1 Xw."""
    dxi, Tcb1, Xb, Xc = _vel_reproj_point(v, T, dt, Tbc, Xw)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    M = Tcb1 @ lie.circle_dot(Xb) @ lie.right_jacobian_pose3(-dxi) * dt[..., None, None]
    return r, pj @ M[..., :3, :]
