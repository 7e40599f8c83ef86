"""Small prior/regularizer factors (port of `amcslam_tpu/factors/priors.py`).

  * velocity regularizer    — EdgeVelocity: soft zero prior on the vertical
    (z) translational velocity, info = QcInv[2,2].
  * extrinsic rotation prior — EdgeExtrinsicPrior.

The velocity-only reprojection (`vel_reproj_*`) waits for the RANSAC port.
Batched over leading dimensions.
"""

from __future__ import annotations

import torch

from ..ops import lie


def velocity_residual(v: torch.Tensor) -> torch.Tensor:
    """r = v[2] (selects vertical velocity; A = [0,0,1,0,0,0])."""
    return v[..., 2:3]


def velocity_jac(v: torch.Tensor) -> torch.Tensor:
    """(..., 1, 12) Jacobian wrt the pose-vel vertex: d r / d v[2] = 1."""
    J = torch.zeros(*v.shape[:-1], 1, 12, dtype=v.dtype, device=v.device)
    J[..., 0, 8] = 1.0  # slot 6+2 in [dxi(6), dv(6)]
    return J


def extrinsic_prior_residual(Tbc: torch.Tensor, R_prior: torch.Tensor) -> torch.Tensor:
    """r = log(R_prior^-1 * Rbc)  (rotation-only extrinsic anchor)."""
    return lie.log_so3(R_prior.transpose(-1, -2) @ Tbc[..., :3, :3])


def extrinsic_prior_jac(Tbc: torch.Tensor, R_prior: torch.Tensor) -> torch.Tensor:
    """(..., 3, 6) Jacobian wrt Tbc <- Tbc exp(de): [0, Jr^-1(r)]."""
    Jr_inv = lie.right_jacobian_so3_inv(extrinsic_prior_residual(Tbc, R_prior))
    return torch.cat([torch.zeros_like(Jr_inv), Jr_inv], -1)
