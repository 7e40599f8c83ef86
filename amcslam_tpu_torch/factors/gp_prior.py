"""Sparse-GP motion-prior factor between consecutive (pose, twist) states.

Port of `amcslam_tpu/factors/gp_prior.py` (EdgeGaussianPrior):

    r = [ log(T1^-1 T2) - dt * v1 ;  Jr^-1(xi12) v2 - v1 ]   (..., 12)
    information = QiInv(dt)

Batched over leading dimensions: poses (..., 4, 4), twists (..., 6),
times (...,).
"""

from __future__ import annotations

import torch

from ..ops import lie


def gp_prior_residual(T1, v1, t1, T2, v2, t2):
    """12-dim GP prior residual (EdgeGaussianPrior::computeError)."""
    xi12 = lie.log_se3(lie.se3_inv(T1) @ T2)
    r_pose = xi12 - (t2 - t1)[..., None] * v1
    r_vel = (lie.right_jacobian_pose3_inv(xi12) @ v2[..., None])[..., 0] - v1
    return torch.cat([r_pose, r_vel], -1)


def gp_prior_residual_jac(T1, v1, t1, T2, v2, t2):
    """Residual + Jacobians wrt both 12-dof states: (r, J1 (...,12,12),
    J2 (...,12,12)), as EdgeGaussianPrior::linearizeOplus:

      dr/dxi1 = [ -Jr^-1(xi) Ad(T12)^-1 ; -1/2 ad(v2) * (that) ]
      dr/dv1  = [ -dt I ; -I ]
      dr/dxi2 = [ Jr^-1(xi) ; -1/2 ad(v2) Jr^-1(xi) ]
      dr/dv2  = [ 0 ; Jr^-1(xi) ]
    """
    T12 = lie.se3_inv(T1) @ T2
    xi = lie.log_se3(T12)
    Jr_inv = lie.right_jacobian_pose3_inv(xi)
    ad_v2 = lie.se3_ad(v2)
    dt = (t2 - t1)[..., None, None]

    r_pose = xi - dt[..., 0] * v1
    r_vel = (Jr_inv @ v2[..., None])[..., 0] - v1
    r = torch.cat([r_pose, r_vel], -1)

    eye6 = torch.eye(6, dtype=T1.dtype, device=T1.device).expand_as(Jr_inv)
    z6 = torch.zeros_like(Jr_inv)
    dxi_dT1 = -(Jr_inv @ lie.adj_se3(lie.se3_inv(T12)))
    J1 = lie._block2(dxi_dT1, -dt * eye6, -0.5 * (ad_v2 @ dxi_dT1), -eye6)
    J2 = lie._block2(Jr_inv, z6, -0.5 * (ad_v2 @ Jr_inv), Jr_inv)
    return r, J1, J2
