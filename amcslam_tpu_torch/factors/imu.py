"""IMU preintegration factor (visual-inertial BA), in PyTorch.

Port of `amcslam_tpu/factors/imu.py`: the preintegrated-IMU residual
between two inertial states (R, p, v) with shared gyro/acc biases

  r_dR = log( dR(b)^T R_i^T R_j )
  r_dV = R_i^T (v_j - v_i - g dT)                 - dV(b)
  r_dP = R_i^T (p_j - p_i - v_i dT - 1/2 g dT^2)  - dP(b)

with dR/dV/dP the first-order bias-corrected preintegrated deltas
(ops/imu.delta_with_bias). The reference takes the Jacobians by
`jax.jacfwd` of the retraction (R <- R exp(dphi), p/v/b additive); here by
one forward-mode pass over 24 stacked copies of the batch
(`solver/sim3_opt._value_and_jac`). Batched over leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import imu, lie
from ..solver.sim3_opt import _value_and_jac

GRAVITY = (0.0, 0.0, -9.81)


class InertialState(NamedTuple):
    R: torch.Tensor   # (...,3,3)
    p: torch.Tensor   # (...,3)
    v: torch.Tensor   # (...,3)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def imu_residual(si: InertialState, sj: InertialState, bg, ba, pre: imu.PreintState,
                 bias_g_lin, bias_a_lin, gravity=None) -> torch.Tensor:
    """(..., 9) preintegration residual at bias (bg, ba); the preintegration
    was computed at (bias_g_lin, bias_a_lin)."""
    g = si.p.new_tensor(GRAVITY) if gravity is None else gravity
    dT = pre.dT[..., None]
    dR, dV, dP = imu.delta_with_bias(pre, bg - bias_g_lin, ba - bias_a_lin)
    RiT = si.R.transpose(-1, -2)
    r_R = lie.log_so3((dR.transpose(-1, -2) @ RiT) @ sj.R)
    r_V = _mv(RiT, sj.v - si.v - g * dT) - dV
    r_P = _mv(RiT, sj.p - si.p - si.v * dT - 0.5 * g * dT * dT) - dP
    return torch.cat([r_R, r_V, r_P], -1)


def retract_inertial(s: InertialState, d: torch.Tensor) -> InertialState:
    """9-dof retraction [dphi, dp, dv]."""
    return InertialState(R=s.R @ lie.exp_so3(d[..., :3]), p=s.p + d[..., 3:6],
                         v=s.v + d[..., 6:9])


def imu_residual_jac(si, sj, bg, ba, pre, bg_lin, ba_lin, gravity=None):
    """Residual and Jacobians with respect to (si 9, sj 9, bg 3, ba 3):
    (r (...,9), Ji (...,9,9), Jj (...,9,9), Jbg (...,9,3), Jba (...,9,3))."""
    def f(d):
        return (imu_residual(retract_inertial(si, d[..., :9]), retract_inertial(sj, d[..., 9:18]),
                             bg + d[..., 18:21], ba + d[..., 21:24], pre, bg_lin, ba_lin,
                             gravity),)

    (r,), (J,) = _value_and_jac(f, 24, tuple(si.p.shape[:-1]), si.p)
    return r, J[..., :9], J[..., 9:18], J[..., 18:21], J[..., 21:24]
